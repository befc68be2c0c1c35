"""The control comes out not correct: the reference computed one precision
below the configuration's (fp8 below bf16, TF32 below f32), in the
program's place, on three seeds, at each cell's own size. Needs the CUDA
card (``chip``); ``python3 benchmark/readings.py --control`` prints the
same readings."""

import argparse
import os

import pytest

from conftest import ROOT, load

MANIFEST = load("BENCHMARK.json")
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.chip
@pytest.mark.parametrize("cell", [c["name"] for c in MANIFEST["workloads"]])
def test_control_is_not_correct(cell, cuda):
    from benchmark import readings, run
    from benchmark.lib import checks

    cell_entry = run.cell_of(MANIFEST, cell)
    for seed in SEEDS:
        ctx = run.make_context(argparse.Namespace(seed=seed, seconds=0.0,
                                                  trace=0),
                               MANIFEST, cell_entry)
        got = checks.limited(readings.control_checks(ctx),
                             readings.limits_of(ctx))
        assert not checks.passed(got), (cell, seed, got)
        assert os.path.exists(os.path.join(ROOT, "BENCHMARK.json"))
