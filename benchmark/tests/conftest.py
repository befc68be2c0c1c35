"""Shared pieces of the benchmark's own tests.

Run them with ``python -m pytest benchmark/tests -q -p no:cacheprovider``
from the repository's root. Tests marked ``chip`` need a CUDA card: they
ask for the ``cuda`` fixture, which skips without one, and run on the card
with the same command.
"""

import json
import os
import sys
import time
from types import SimpleNamespace

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


@pytest.fixture
def tiny():
    return tiny_context


def tiny_context(workload: str, seed: int = 2**31 + 11, seconds=0.5,
                 device="cpu", **traffic):
    """A run's context for ``workload`` at a size the CPU holds: its
    traffic cut to ``traffic``'s overrides (default: 4 trees of 2,048
    points, 2 a step), voxels of 6 cm so that those sparse scans still
    coarsen level by level, and no profiler."""
    import importlib

    manifest = load("BENCHMARK.json")
    cell = next(c for c in manifest["workloads"] if c["name"] == workload)
    entry = next(c for c in manifest["configs"]
                 if c["name"] == cell["config"])
    config = load(entry["file"])
    config["model"]["voxel_size"] = 0.06
    spec = load("benchmark", "traffic", f"{cell['traffic']}.json")
    spec.update({"trees": 4, "points_per_tree": 2048, "batch_size": 2,
                 **traffic})
    return SimpleNamespace(
        cell=cell, config=config, traffic=spec, seed=seed,
        device=torch.device(device), seconds=seconds,
        t_start=time.perf_counter(), trace_seconds=seconds / 2,
        reference=importlib.import_module(
            f"benchmark.reference.{config['reference']}"),
        recorder=lambda: None)
