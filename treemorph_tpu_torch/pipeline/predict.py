"""Stage 1: model-based offset refinement + denoising.

Port of the TreeLearn / PTv3 path of ``treemorph_tpu/pipeline/predict.py``
(reference ``Modules/Pipeline/ModelPredicting.py:16-95``):
:func:`predict_single` runs one forward per tree, applies the predicted
offsets, then drops points whose noise-head argmax is class 1 (class 0 is
kept). The rasterized PointNet2 path is not ported yet.
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


def make_predictions(
    cloud: np.ndarray,
    model_type: str,
    offset_model: Predictor | None = None,
    noise_model: Predictor | None = None,
    predict_offset: bool = True,
    denoise: bool = True,
    device=None,
) -> np.ndarray:
    """Dispatch by family (reference Pipeline.py:110-131)."""
    if model_type in ("treelearn", "pointtransformerv3"):
        return predict_single(
            cloud, offset_model, noise_model, predict_offset, denoise,
            device=device,
        )
    if model_type == "no_model":
        return np.asarray(cloud, np.float32)[:, :3]
    if model_type == "pointnet2":
        raise NotImplementedError(f"model family {model_type!r} is not ported")
    raise ValueError(f"unknown model type {model_type!r}")
