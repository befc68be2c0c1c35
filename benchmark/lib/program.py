"""The system under test: the entry points, counters and kernel names the
benchmark takes from the port, ``treemorph_tpu_torch``. This module is the
harness's only door into it; nothing of the reference passes through.
"""

from __future__ import annotations

import importlib

PACKAGE = "treemorph_tpu_torch"


def port(module: str):
    """``treemorph_tpu_torch.{module}``."""
    return importlib.import_module(f"{PACKAGE}.{module}")


def build_model(family: str, model_cfg: dict, batch_size: int,
                dataset=None):
    """The family's model as the training CLI builds it
    (``train/cli.py::build``), parameters uninitialized; TreeLearn's
    level-0 voxel capacity worked out from ``dataset``'s clouds as the CLI
    does (``train/cli.py::level0_capacity``)."""
    if family == "treelearn":
        capacity = None if dataset is None else port(
            "train.cli").level0_capacity((dataset,), batch_size,
                                         model_cfg["voxel_size"])
        return port("models.treelearn").TreeLearn(
            batch_size=batch_size, voxel_capacity=capacity, **model_cfg)
    if family == "ptv3":
        return port("models.ptv3").PointTransformerWithHeads(**model_cfg)
    raise ValueError(f"no model family {family!r}")


def family_steps(family: str):
    """The harness's ``(forward_fn, loss_fn)`` of ``family``."""
    families = port("train.families")
    return {"treelearn": families.treelearn_family,
            "ptv3": families.ptv3_family}[family]()


def launches() -> dict:
    """The hand-kernel launches the port has counted so far."""
    return dict(port("ops.cuda").LAUNCHES)


def build_kernels() -> float:
    """Compile every CUDA source the port has that is not built yet;
    returns the wall seconds."""
    return port("ops.cuda").build_all()


#: the pipeline's name of each family (``stage1.model_type``)
MODEL_TYPES = {"treelearn": "treelearn", "ptv3": "pointtransformerv3"}


def predictor(family: str, model, device):
    """The pipeline's :class:`Predictor` of ``model``, which also keeps the
    result of each forward in its ``recorded`` list while that is a list
    (``None``: keeps nothing)."""
    base = port("evaluation.model_loaders").Predictor

    class Recording(base):
        recorded = None

        def predict_flat(self, *arrays):
            result = super().predict_flat(*arrays)
            if self.recorded is not None:
                self.recorded.append(result)
            return result

    return Recording(MODEL_TYPES[family], model, device)


def serve_cloud(cloud, family: str, offset_model, noise_model, stage2: dict,
                device):
    """One cloud through stage 1 (``pipeline/predict.py::make_predictions``,
    offsets then denoising) and stage 2 (``pipeline/upsample.py::
    upsample``) with the arguments and guards of ``run_pipeline`` (an empty
    refined cloud, or one over ``UPSAMPLE_SKIP_THRESHOLD`` points, skips
    stage 2); returns both stages' host arrays and the seconds each
    took."""
    import time

    predict = port("pipeline.predict")
    upsample = port("pipeline.upsample")
    skip_above = port("pipeline.run").UPSAMPLE_SKIP_THRESHOLD
    t0 = time.perf_counter()
    refined = predict.make_predictions(
        cloud, MODEL_TYPES[family], offset_model=offset_model,
        noise_model=noise_model, predict_offset=True, denoise=True,
        device=device)
    t1 = time.perf_counter()
    dense = refined
    if 0 < len(refined) <= skip_above:
        dense = upsample.upsample(refined, device=device, **stage2)
    t2 = time.perf_counter()
    return refined, dense, t1 - t0, t2 - t1
