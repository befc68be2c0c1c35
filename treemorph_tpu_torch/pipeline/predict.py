"""Stage 1: model-based offset refinement + denoising.

Port of ``treemorph_tpu/pipeline/predict.py`` (reference
``Modules/Pipeline/ModelPredicting.py``):

- :func:`predict_single` (TreeLearn / PTv3, ``:16-95``) runs one forward
  per tree, applies the predicted offsets, then drops points whose
  noise-head argmax is class 1 (class 0 is kept).
- :func:`predict_rasterized` (PointNet2, ``:166-250``) cuts the cloud into
  overlapping cubes (:func:`raster_assignments`), runs fixed-shape
  minibatches of rasters through the padded-batch model on the device,
  and averages each point's predictions over every raster that holds it in
  float64 on the host (the reference's streaming scatter-mean,
  ``PointNet2.py:210-327``).
- :func:`predict_rasterized_sharded` (JAX ``predict.py:264-418``) splits the
  rasters over the devices of a
  :class:`~treemorph_tpu_torch.parallel.LocalMesh`: one process drives every
  device, as JAX's single controller does, so the pipeline needs no
  launcher. Each device runs its own minibatches through its own replica of
  the model and scatter-adds into its own f32 accumulator and count over
  the whole cloud; each accumulator is then reduced once, a reduce-scatter
  (slice k of the points summed onto device k), before anything leaves the
  devices.
"""

from __future__ import annotations

import copy
import logging
from functools import partial

import numpy as np
import torch

from ..evaluation.model_loaders import Predictor
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

#: cross-device reductions of :func:`predict_rasterized_sharded`, one per
#: accumulator (the chip script and the tests read it)
REDUCTIONS = {"reduce_scatter": 0}


def pad_to_bucket(n: int, bucket: int = 1024) -> int:
    """Round n up to a multiple of ``bucket`` (at least one bucket)."""
    return max(((n + bucket - 1) // bucket) * bucket, bucket)


def _pad_flat(points: np.ndarray, feats: np.ndarray, bucket: int = 1024,
              device=None):
    n = len(points)
    p = pad_to_bucket(n, bucket)
    coords = np.zeros((p, 3), np.float32)
    f = np.zeros((p, feats.shape[1]), np.float32)
    coords[:n] = points
    f[:n] = feats
    valid = np.arange(p) < n
    return (
        torch.from_numpy(coords).to(device),
        torch.from_numpy(f).to(device),
        torch.zeros(p, dtype=torch.int32, device=device),
        torch.from_numpy(valid).to(device),
        n,
    )


def predict_single(
    cloud: np.ndarray,
    offset_model: Predictor | None = None,
    noise_model: Predictor | None = None,
    predict_offset: bool = True,
    denoise: bool = True,
    bucket: int = 1024,
    device=None,
) -> np.ndarray:
    """TreeLearn/PTv3 path: whole-tree forward, offsets then denoise.
    Inputs are
    padded on ``device`` (the CUDA device unless named; raises without
    one), where the models must live."""
    device = resolve_device(device)
    pts = np.asarray(cloud, np.float32)[:, :3]
    if not predict_offset and not denoise:
        return pts
    feats = (
        np.asarray(cloud, np.float32)[:, 7:11]
        if cloud.shape[1] >= 11
        else np.zeros((len(pts), 4), np.float32)
    )
    coords, f, batch_ids, valid, n = _pad_flat(pts, feats, bucket, device)

    out = pts.copy()
    if predict_offset and offset_model is not None:
        res = _predict_flat_retry(
            offset_model, coords, f, batch_ids, valid, "offset model"
        )
        out = out + res["offset_predictions"][:n].cpu().numpy()
    if denoise and noise_model is not None:
        res = _predict_flat_retry(
            noise_model, coords, f, batch_ids, valid, "noise model"
        )
        logits = res["semantic_prediction_logits"][:n].cpu().numpy()
        keep = logits.argmax(axis=1) == 0
        out = out[keep]
    return out


#: per-family capacity settings that cannot overflow on ANY input
#: (divisor 1 = arrays sized to the worst case; pool_shrink 2 is lossless
#: for stride-2 coarsening). Weights do not depend on capacities, so they
#: carry straight into the relaxed model.
SAFE_CAP_OVERRIDES = {
    "treelearn": dict(voxel_capacity_divisor=1),
    "pointtransformerv3": dict(dedup_divisor=1, pool_shrink=2),
}


def _overflow_total(res: dict) -> int:
    return sum(
        int(res.get(k, 0) or 0)
        for k in (
            "dropped_points", "dropped_voxels", "dedup_overflow",
            "pool_overflow",
        )
    )


def _predict_flat_retry(model: Predictor, coords, f, batch_ids, valid,
                        what: str) -> dict:
    """Forward with automatic higher-cap retry: if the tuned caps drop
    anything on this cloud, re-run once with the family's overflow-proof
    capacities instead of returning degraded predictions."""
    res = model.predict_flat(coords, f, batch_ids, valid)
    n_over = _overflow_total(res)
    if n_over:
        safe = SAFE_CAP_OVERRIDES.get(model.family, {})
        relax = {
            k: v
            for k, v in safe.items()
            if model.model.config.get(k, v) != v
        }
        if relax:
            logger.warning(
                "%s overflowed its capacities (%d dropped) — retrying with "
                "safe capacities %s", what, n_over, relax,
            )
            relaxed = Predictor(
                model.family, model.model.clone(**relax), model.device
            )
            res = relaxed.predict_flat(coords, f, batch_ids, valid)
            n_over = _overflow_total(res)
        if n_over:
            _warn_dropped(res, what)
    return res


def _warn_dropped(res: dict, what: str) -> None:
    """Surface capacity overflow (dropped voxels silently degrade
    predictions)."""
    total = _overflow_total(res)
    if total:
        logger.warning(
            "%s overflowed its capacities even at safe capacities: %d "
            "units dropped — predictions are degraded for this cloud",
            what, total,
        )


def raster_assignments(
    points: np.ndarray, raster_size: float, stride: float
) -> list[tuple[tuple, np.ndarray]]:
    """Point indices grouped by overlapping cubic rasters, on the host
    (the reference rasterizer loop, ``ModelPredicting.py:98-163``): a point
    at p belongs to every raster with origin ``min + j * stride`` and
    ``origin <= p < origin + raster_size``. Returns (raster key, point
    indices) for the non-empty rasters, ordered by key."""
    pts = np.asarray(points, np.float64)[:, :3]
    mins = pts.min(axis=0)
    maxs = pts.max(axis=0)
    n_overlap = max(int(np.ceil(raster_size / stride)), 1)
    # the raster grid's extent, as the reference's arange(min, max, stride)
    n_cells = np.maximum(np.ceil((maxs - mins) / stride), 1).astype(int)

    base = np.floor((pts - mins) / stride).astype(int)
    groups: dict[tuple, list] = {}
    for sx in range(n_overlap):
        for sy in range(n_overlap):
            for sz in range(n_overlap):
                j = base - np.array([sx, sy, sz])
                origin = mins + j * stride
                ok = (
                    (j >= 0).all(axis=1)
                    & (j < n_cells).all(axis=1)
                    & (pts >= origin).all(axis=1)
                    & (pts < origin + raster_size).all(axis=1)
                )
                idx = np.nonzero(ok)[0]
                if len(idx) == 0:
                    continue
                keys = j[idx]
                order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
                idx, keys = idx[order], keys[order]
                bounds = np.nonzero(np.any(np.diff(keys, axis=0) != 0,
                                           axis=1))[0] + 1
                for s, e in zip(np.concatenate([[0], bounds]),
                                np.concatenate([bounds, [len(idx)]])):
                    groups.setdefault(tuple(keys[s]), []).append(idx[s:e])
    return [(key, np.concatenate(groups[key])) for key in sorted(groups)]


def predict_rasterized(
    cloud: np.ndarray,
    offset_model: Predictor | None = None,
    noise_model: Predictor | None = None,
    predict_offset: bool = True,
    denoise: bool = True,
    raster_size: float = 1.0,
    stride: float = 1.0,
    minibatch_size: int = 60,
    bucket: int = 512,
    device=None,
) -> np.ndarray:
    """PointNet2 path: rasterize, run batched forwards, scatter-mean.
    Every minibatch is ``(minibatch_size, max_pts)`` points, ``max_pts``
    the largest raster rounded up to ``bucket`` (the last minibatch padded
    with empty rasters), on ``device`` (the CUDA device unless named;
    raises without one), where the models must live."""
    device = resolve_device(device)
    pts = np.asarray(cloud, np.float32)[:, :3]
    if not predict_offset and not denoise:
        return pts
    feats = (
        np.asarray(cloud, np.float32)[:, 7:11]
        if cloud.shape[1] >= 11
        else np.zeros((len(pts), 4), np.float32)
    )
    rasters = raster_assignments(pts, raster_size, stride)
    if not rasters:
        return pts
    max_pts = pad_to_bucket(max(len(i) for _, i in rasters), bucket)

    def run_model(model: Predictor, want: str) -> np.ndarray:
        dim = 3 if want == "offset_predictions" else 2
        acc = np.zeros((len(pts), dim), np.float64)
        cnt = np.zeros(len(pts), np.int64)
        for start in range(0, len(rasters), minibatch_size):
            chunk = rasters[start:start + minibatch_size]
            coords = np.zeros((minibatch_size, max_pts, 3), np.float32)
            f = np.zeros((minibatch_size, max_pts, feats.shape[1]),
                         np.float32)
            valid = np.zeros((minibatch_size, max_pts), bool)
            for i, (_, idx) in enumerate(chunk):
                coords[i, :len(idx)] = pts[idx]
                f[i, :len(idx)] = feats[idx]
                valid[i, :len(idx)] = True
            out = model.predict_padded(
                *(torch.from_numpy(a).to(device) for a in (coords, f, valid))
            )
            vals = out[want].float().cpu().numpy()
            for i, (_, idx) in enumerate(chunk):
                acc[idx] += vals[i, :len(idx)]
                cnt[idx] += 1
        nz = cnt > 0
        acc[nz] /= cnt[nz, None]
        return acc.astype(np.float32)

    out = pts.copy()
    if predict_offset and offset_model is not None:
        out = out + run_model(offset_model, "offset_predictions")
    if denoise and noise_model is not None:
        logits = run_model(noise_model, "semantic_prediction_logits")
        out = out[logits.argmax(axis=1) == 0]
    return out


def _replica(model: Predictor, device) -> Predictor:
    """``model`` on ``device``: itself there, else a copy moved there."""
    if torch.device(device) == model.device:
        return model
    return Predictor(model.family, copy.deepcopy(model.model), device)


def _reduce_scatter(parts: list, devices) -> list:
    """Sum the per-device tensors ``parts`` (the same shape, leading dim a
    multiple of the device count) in one reduce-scatter: slice k of the
    leading dim is summed onto device k. Returns the slices in order."""
    REDUCTIONS["reduce_scatter"] += 1
    n = len(devices)
    step = parts[0].shape[0] // n
    out = []
    for k, dev in enumerate(devices):
        rows = slice(k * step, (k + 1) * step)
        total = parts[k][rows].clone()
        for d, part in enumerate(parts):
            if d != k:
                total += part[rows].to(dev)
        out.append(total)
    return out


def predict_rasterized_sharded(
    cloud: np.ndarray,
    offset_model: Predictor | None = None,
    noise_model: Predictor | None = None,
    predict_offset: bool = True,
    denoise: bool = True,
    raster_size: float = 1.0,
    stride: float = 1.0,
    minibatch_size: int = 60,
    bucket: int = 512,
    mesh=None,
    device=None,
) -> np.ndarray:
    """Plot-scale PointNet2 inference sharded over the devices of ``mesh``
    (a :class:`~treemorph_tpu_torch.parallel.LocalMesh`); without a mesh it
    is :func:`predict_rasterized` on ``device``.

    The rasters are split over the devices as JAX splits them: each device
    gets ``r_per_dev`` of them, the raster count over the devices rounded
    up to whole ``(minibatch_size, max_pts)`` minibatches, the tail padded
    with empty rasters (minibatches that hold no raster are not run). Each
    device scatter-adds its forwards' outputs into an f32 ``(n_pad, dim)``
    accumulator and count on that device (``n_pad``: the point count
    rounded up to the device count), and each accumulator is reduced once
    (a reduce-scatter). Per point the result is :func:`predict_rasterized`'s
    (the same rasters, forwards and scatter-mean), summed in f32 on the
    devices instead of float64 on the host."""
    if mesh is None:
        return predict_rasterized(
            cloud, offset_model, noise_model, predict_offset, denoise,
            raster_size=raster_size, stride=stride,
            minibatch_size=minibatch_size, bucket=bucket, device=device,
        )
    pts = np.asarray(cloud, np.float32)[:, :3]
    if not predict_offset and not denoise:
        return pts
    feats = (
        np.asarray(cloud, np.float32)[:, 7:11]
        if cloud.shape[1] >= 11
        else np.zeros((len(pts), 4), np.float32)
    )
    rasters = raster_assignments(pts, raster_size, stride)
    if not rasters:
        return pts
    devices = mesh.devices
    n_dev = len(devices)
    max_pts = pad_to_bucket(max(len(i) for _, i in rasters), bucket)

    # the raster -> point gather table, padded so that every device gets
    # the same number of whole minibatches
    r_per_dev = -(-len(rasters) // n_dev)
    r_per_dev = -(-r_per_dev // minibatch_size) * minibatch_size
    idx = np.zeros((r_per_dev * n_dev, max_pts), np.int64)
    vmask = np.zeros((r_per_dev * n_dev, max_pts), bool)
    for i, (_, pidx) in enumerate(rasters):
        idx[i, :len(pidx)] = pidx
        vmask[i, :len(pidx)] = True
    n = len(pts)
    n_pad = -(-n // n_dev) * n_dev
    inputs = {}
    for dev in dict.fromkeys(devices):
        inputs[dev] = tuple(torch.from_numpy(a).to(dev) for a in (
            pts, feats, idx, vmask))

    def run_model(model: Predictor, want: str) -> np.ndarray:
        dim = 3 if want == "offset_predictions" else 2
        replicas = {dev: _replica(model, dev) for dev in inputs}
        accs = [torch.zeros((n_pad, dim), dtype=torch.float32, device=dev)
                for dev in devices]
        cnts = [torch.zeros(n_pad, dtype=torch.float32, device=dev)
                for dev in devices]
        # minibatch by minibatch, each device in turn, so that the devices'
        # queues fill together
        for start in range(0, r_per_dev, minibatch_size):
            for d, dev in enumerate(devices):
                rows = slice(d * r_per_dev + start,
                             d * r_per_dev + start + minibatch_size)
                if not vmask[rows].any():
                    continue
                p, f, ix, vm = inputs[dev]
                ci, cv = ix[rows], vm[rows]
                keep = cv[..., None]
                out = replicas[dev].predict_padded(
                    torch.where(keep, p[ci], 0.0),
                    torch.where(keep, f[ci], 0.0), cv)
                vals = torch.where(cv[..., None], out[want].float(), 0.0)
                flat = ci.reshape(-1)
                accs[d].index_add_(0, flat, vals.reshape(-1, dim))
                cnts[d].index_add_(0, flat, cv.reshape(-1).float())
        acc = torch.cat([a.cpu() for a in _reduce_scatter(accs, devices)])
        cnt = torch.cat([c.cpu() for c in _reduce_scatter(cnts, devices)])
        acc, cnt = acc[:n].numpy(), cnt[:n].numpy()
        nz = cnt > 0
        acc[nz] /= cnt[nz, None]
        return acc

    out = pts.copy()
    if predict_offset and offset_model is not None:
        out = out + run_model(offset_model, "offset_predictions")
    if denoise and noise_model is not None:
        logits = run_model(noise_model, "semantic_prediction_logits")
        out = out[logits.argmax(axis=1) == 0]
    return out


def make_predictions(
    cloud: np.ndarray,
    model_type: str,
    offset_model: Predictor | None = None,
    noise_model: Predictor | None = None,
    predict_offset: bool = True,
    denoise: bool = True,
    raster_size: float = 1.0,
    stride: float = 1.0,
    minibatch_size: int = 60,
    device=None,
    mesh=None,
) -> np.ndarray:
    """Dispatch by family (reference Pipeline.py:110-131); the raster
    arguments are PointNet2's. With ``mesh`` (a
    :class:`~treemorph_tpu_torch.parallel.LocalMesh`) the raster path
    shards its tiles over the mesh's devices."""
    if model_type in ("treelearn", "pointtransformerv3"):
        return predict_single(
            cloud, offset_model, noise_model, predict_offset, denoise,
            device=device,
        )
    if model_type == "pointnet2":
        raster = predict_rasterized if mesh is None else partial(
            predict_rasterized_sharded, mesh=mesh)
        return raster(
            cloud, offset_model, noise_model, predict_offset, denoise,
            raster_size=raster_size, stride=stride,
            minibatch_size=minibatch_size, device=device,
        )
    if model_type == "no_model":
        return np.asarray(cloud, np.float32)[:, :3]
    raise ValueError(f"unknown model type {model_type!r}")
