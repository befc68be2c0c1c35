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
  ``PointNet2.py:210-327``). It is the single-device form of the JAX
  package's ``predict_rasterized_sharded``; the sharded form over several
  cards is not ported.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..evaluation.model_loaders import Predictor
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


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
) -> np.ndarray:
    """Dispatch by family (reference Pipeline.py:110-131); the raster
    arguments are PointNet2's."""
    if model_type in ("treelearn", "pointtransformerv3"):
        return predict_single(
            cloud, offset_model, noise_model, predict_offset, denoise,
            device=device,
        )
    if model_type == "pointnet2":
        return predict_rasterized(
            cloud, offset_model, noise_model, predict_offset, denoise,
            raster_size=raster_size, stride=stride,
            minibatch_size=minibatch_size, device=device,
        )
    if model_type == "no_model":
        return np.asarray(cloud, np.float32)[:, :3]
    raise ValueError(f"unknown model type {model_type!r}")
