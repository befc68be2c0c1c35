"""Rules the port keeps: it imports neither JAX nor the JAX package, and its
entry points run on the CUDA device unless the caller names another, so
without one the default raises instead of quietly running on the CPU."""

import ast
import os
import re

import numpy as np
import pytest
import torch

import treemorph_tpu_torch
from treemorph_tpu_torch.evaluation.model_loaders import Predictor, build_model
from treemorph_tpu_torch.ops.cuda import CSRC_DIR, KERNEL_FUNCTIONS, kernel_names
from treemorph_tpu_torch.pipeline.predict import predict_single
from treemorph_tpu_torch.pipeline.run import run_pipeline
from treemorph_tpu_torch.pipeline.upsample import upsample_device
from treemorph_tpu_torch.pipeline import upsample
from treemorph_tpu_torch.scripts import exec_pipeline, profile_zband

PACKAGE = os.path.dirname(treemorph_tpu_torch.__file__)
REPO = os.path.dirname(PACKAGE)
#: the JAX side, and the libraries the card's machine lacks (its config
#: files are read without a YAML library, its tables without pandas, the
#: JAX package's orbax checkpoints without tensorstore or zstandard)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "treemorph_tpu",
             "yaml", "pandas", "tensorstore", "zstandard")


def imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def port_sources():
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "time_kernels.py")
    yield os.path.join(REPO, "compare_sass.py")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = list(port_sources())
    assert len(sources) > 20
    for path in sources:
        for mod in imported_modules(path):
            root = mod.split(".")[0]
            assert root not in FORBIDDEN, f"{path} imports {mod}"


def test_kernel_functions_name_every_global_function():
    """``ops.cuda.KERNEL_FUNCTIONS`` lists each source's ``__global__``
    functions; the chip script's profiles pick the port's kernels out by
    these names."""
    assert sorted(KERNEL_FUNCTIONS) == kernel_names()
    for name, functions in KERNEL_FUNCTIONS.items():
        with open(os.path.join(CSRC_DIR, f"{name}.cu")) as f:
            src = f.read()
        assert src.count("__global__") == len(functions), name
        for function in functions:
            assert re.search(rf"\b{function}\(", src), (name, function)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    cloud = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    model = build_model("treelearn", device="cpu", channels=8,
                        num_blocks=1)
    tiny_ptv3 = dict(enc_depths=(1,), enc_channels=(8,), enc_num_head=(1,),
                     enc_patch_size=(64,), dec_depths=(), dec_channels=(),
                     dec_num_head=(), dec_patch_size=())
    ptv3 = Predictor("pointtransformerv3", build_model(
        "pointtransformerv3", device="cpu", **tiny_ptv3), "cpu")
    calls = [
        lambda: build_model("treelearn", channels=8, num_blocks=1),
        lambda: build_model("pointtransformerv3", **tiny_ptv3),
        lambda: Predictor("treelearn", model),
        lambda: predict_single(cloud),
        lambda: predict_single(cloud, ptv3, ptv3),
        lambda: upsample(cloud, min_points=100),
        lambda: upsample_device(cloud, min_points=100),
        lambda: run_pipeline({"general": {"input_dir": str(tmp_path),
                                          "output_dir": str(tmp_path)},
                              "stage1": {"model_type": "treelearn"}}),
        lambda: profile_zband.main([]),
        lambda: exec_pipeline.main(["--config", str(config)]),
    ]
    config = tmp_path / "cfg.json"
    config.write_text('{"general": {"input_dir": "%s", "output_dir": "%s"}, '
                      '"stage1": {"model_type": "treelearn"}}'
                      % (tmp_path, tmp_path))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # named, the CPU is used
    assert Predictor("treelearn", model, "cpu").device.type == "cpu"
