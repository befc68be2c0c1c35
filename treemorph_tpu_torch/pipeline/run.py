"""End-to-end pipeline orchestrator.

Capability parity with reference ``Modules/Pipeline/Pipeline.py:49-182`` and
``PipelineExecution/exec_pipeline.py``: list input clouds, then per cloud
run stage 1 (model offset + denoise: one forward per tree for TreeLearn
and PTv3, rasters for PointNet2), stage 2 (upsampling, skipped above 1.5M
points), stage 3 (QSM fitting), with per-cloud exception isolation.
The config dict follows the schema of ``configs/pipeline_config.yaml``
(the reference's ``PipelineExecution/pipeline_config.yaml``). The stage-1
models are the caller's, or else the port's checkpoints under the config's
``model_dirs`` (the reference's hardcoded registry, ``Pipeline.py:12-16``,
becomes that mapping; :func:`load_pipeline_models`).
``python -m treemorph_tpu_torch.scripts.exec_pipeline`` runs it from a
config file. Every stage runs on one device, the CUDA device unless the
caller names another; where several CUDA cards are visible, PointNet2's
raster inference shards its tiles over all of them
(:func:`~treemorph_tpu_torch.pipeline.predict.predict_rasterized_sharded`),
and stages 2 and 3 run once, on that device and the host.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..evaluation.model_loaders import load_model
from ..utils.device import resolve_device
from ..utils.io import load_cloud, save_cloud
from .predict import make_predictions
from .qsm import QSMParams, fit_qsm
from .upsample import upsample

logger = logging.getLogger("treemorph_tpu_torch.pipeline")

UPSAMPLE_SKIP_THRESHOLD = 1_500_000  # reference Pipeline.py:144

DEFAULT_MODEL_DIRS = {
    "treelearn": [
        os.path.join("ModelSaves", "TreeLearn", "offset"),
        os.path.join("ModelSaves", "TreeLearn", "noise"),
    ],
    "pointnet2": [
        os.path.join("ModelSaves", "PointNet2", "offset"),
        os.path.join("ModelSaves", "PointNet2", "noise"),
    ],
    "pointtransformerv3": [
        os.path.join("ModelSaves", "PointTransformerV3", "offset"),
        os.path.join("ModelSaves", "PointTransformerV3", "noise"),
    ],
}

SUPPORTED_EXT = (".txt", ".npy", ".laz", ".las")


def load_pipeline_models(cfg: dict, model_type: str, device=None):
    """The offset and noise :class:`Predictor`s of the config's
    ``model_dirs`` registry (``[offset_dir, noise_dir]`` per family, each
    holding the training CLI's ``P{n}`` checkpoints), on ``device``. Plot 3
    is taken first, like the reference's "O_P3" / "N_P3"
    (``Pipeline.py:31-35``), then any loaded plot; ``(None, None)`` where
    stage 1 needs no model. An optional ``stage1.engine`` (a checkpoint
    does not record it) builds the models on that conv engine: TreeLearn's
    ``engine``, PTv3's ``stem_engine`` (``pencil`` meaning gather, as the
    training CLI has it)."""
    predict_offset = cfg["stage1"]["predict_offset"]
    denoise = cfg["stage1"]["denoise"]
    if not (predict_offset or denoise) or model_type == "no_model":
        return None, None
    dirs = cfg.get("model_dirs", DEFAULT_MODEL_DIRS).get(model_type)
    if dirs is None:
        return None, None
    offset_dir, noise_dir = dirs
    overrides = {}
    engine = cfg["stage1"].get("engine")
    if engine is not None and model_type == "treelearn":
        overrides["engine"] = engine
    elif engine is not None and model_type == "pointtransformerv3":
        overrides["stem_engine"] = "gather" if engine == "pencil" else engine
    models = load_model(model_type, offset_model_dir=offset_dir,
                        noise_model_dir=noise_dir, device=device,
                        **overrides)

    def pick(prefix):
        for key in (f"{prefix}_P3", *sorted(models)):
            if key.startswith(prefix) and key in models:
                return models[key]
        return None

    return (
        pick("O") if predict_offset else None,
        pick("N") if denoise else None,
    )


def run_pipeline(cfg: dict, offset_model=None, noise_model=None,
                 device=None):
    """Run the full stage1->2->3 pipeline over a directory of clouds, on
    ``device`` (the CUDA device unless named; raises without one).

    The stage-1 models may be given as :class:`Predictor`s on that device;
    otherwise they are loaded from the config's ``model_dirs``
    (:func:`load_pipeline_models`).
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

    if offset_model is None and noise_model is None:
        offset_model, noise_model = load_pipeline_models(cfg, model_type,
                                                         device)

    # plot-scale raster inference shards over every card where there are
    # several (JAX run.py:103-110)
    mesh = None
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        from ..parallel import make_local_mesh

        mesh = make_local_mesh()

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
                    mesh=mesh,
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
