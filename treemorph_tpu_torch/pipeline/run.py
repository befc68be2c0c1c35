"""End-to-end pipeline orchestrator.

Capability parity with reference ``Modules/Pipeline/Pipeline.py:49-182`` and
``PipelineExecution/exec_pipeline.py``: list input clouds, then per cloud
run stage 1 (model offset + denoise: one forward per tree for TreeLearn
and PTv3, rasters for PointNet2), stage 2 (upsampling, skipped above 1.5M
points), stage 3 (QSM fitting), with per-cloud exception isolation.
The config dict follows the schema of ``configs/pipeline_config.yaml``
(the reference's ``PipelineExecution/pipeline_config.yaml``). Models are
given by the caller: loading checkpoints from ``model_dirs`` is not ported
yet. Every stage runs on one device, the CUDA device unless the caller
names another.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from ..utils.device import resolve_device
from ..utils.io import load_cloud, save_cloud
from .predict import make_predictions
from .qsm import QSMParams, fit_qsm
from .upsample import upsample

logger = logging.getLogger("treemorph_tpu_torch.pipeline")

UPSAMPLE_SKIP_THRESHOLD = 1_500_000  # reference Pipeline.py:144

SUPPORTED_EXT = (".txt", ".npy", ".laz", ".las")


def run_pipeline(cfg: dict, offset_model=None, noise_model=None,
                 device=None):
    """Run the full stage1->2->3 pipeline over a directory of clouds, on
    ``device`` (the CUDA device unless named; raises without one).

    The stage-1 models are given as :class:`Predictor`s on that device.
    """
    device = resolve_device(device)
    general = cfg["general"]
    input_dir = general["input_dir"]
    output_dir = os.path.join(
        general["output_dir"], cfg["stage1"]["model_type"]
    )
    os.makedirs(output_dir, exist_ok=True)
    model_type = cfg["stage1"]["model_type"]

    cloud_paths = sorted(
        os.path.join(input_dir, f)
        for f in os.listdir(input_dir)
        if os.path.splitext(f)[1].lower() in SUPPORTED_EXT
        and os.path.isfile(os.path.join(input_dir, f))
    )
    if not cloud_paths:
        logger.error("no supported clouds found in %s", input_dir)
        return []

    needs_models = model_type != "no_model" and (
        cfg["stage1"]["predict_offset"] or cfg["stage1"]["denoise"]
    )
    if needs_models and offset_model is None and noise_model is None:
        raise NotImplementedError(
            "loading checkpoints from model_dirs is not ported; pass "
            "offset_model / noise_model"
        )

    results = []
    for cloud_path in cloud_paths:
        base = os.path.splitext(os.path.basename(cloud_path))[0]
        t0 = time.time()
        try:
            cloud = load_cloud(cloud_path, all_columns=True)
            if cloud is None:
                logger.warning("failed to load %s; skipping", cloud_path)
                continue

            # Stage 1
            if cfg["stage1"]["predict_offset"] or cfg["stage1"]["denoise"]:
                data = make_predictions(
                    cloud,
                    model_type,
                    offset_model=offset_model,
                    noise_model=noise_model,
                    predict_offset=cfg["stage1"]["predict_offset"],
                    denoise=cfg["stage1"]["denoise"],
                    device=device,
                )
                if general.get("save_model_predictions"):
                    suffix = "_pred" if cfg["stage1"]["predict_offset"] else ""
                    suffix += "_denoised" if cfg["stage1"]["denoise"] else ""
                    save_cloud(
                        data,
                        os.path.join(output_dir, base + suffix),
                        general.get("cloud_save_type", "npy"),
                    )
            else:
                data = np.asarray(cloud, np.float32)[:, :3]
            if data is None or len(data) == 0:
                continue

            # Stage 2
            if cfg["stage2"]["upsampling"]:
                if len(data) > UPSAMPLE_SKIP_THRESHOLD:
                    logger.info(
                        "%s: skipping upsampling (%d pts)", base, len(data)
                    )
                else:
                    data = upsample(
                        data,
                        k_init=cfg["stage2"]["k_init"],
                        max_iterations=cfg["stage2"]["max_iterations"],
                        min_height=cfg["stage2"]["min_height"],
                        use_only_original_points=cfg["stage2"][
                            "use_only_original_points"
                        ],
                        min_points=cfg["stage2"]["min_points"],
                        device=device,
                    )
                    if general.get("save_upsampling"):
                        save_cloud(
                            data,
                            os.path.join(output_dir, base + "_supsamp"),
                            general.get("cloud_save_type", "npy"),
                        )

            # Stage 3
            df = None
            if cfg["stage3"]["qsm_fitting"]:
                params = QSMParams.from_dict(cfg["stage3"]["qsm_params"])
                df, _, _, _ = fit_qsm(
                    data,
                    params=params,
                    output_base=os.path.join(
                        output_dir, f"{base}_qsm_depth"
                    ),
                    save_csv=general.get("save_qsm_cyl_csv", True),
                    save_cyl_ply=general.get("save_qsm_cyl_ply", False),
                    save_sphere_ply=general.get(
                        "save_qsm_sphere_ply", False
                    ),
                    verbose=cfg["stage3"].get("qsm_verbose", False),
                    debug_log_path=(
                        os.path.join(output_dir, f"{base}_qsm.log")
                        if cfg["stage3"].get("qsm_debug")
                        else None
                    ),
                )
            results.append(
                {
                    "cloud": cloud_path,
                    "points": len(data),
                    "cylinders": 0 if df is None else len(df),
                    "seconds": time.time() - t0,
                }
            )
            logger.info(
                "%s done in %.1fs", base, results[-1]["seconds"]
            )
        except Exception:
            logger.exception("pipeline failed for %s; continuing", cloud_path)
    return results
