"""Tracing and profiling helpers.

Port of ``treemorph_tpu/utils/profiling.py`` (the reference's
observability hooks, SURVEY.md §5): cProfile around every QSM fit (kept,
``pipeline/qsm/engine.fit_qsm(profile=...)``), host stage timers, and
``torch.profiler`` traces of the card, which Perfetto or
``chrome://tracing`` open.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("treemorph_tpu_torch.profiling")


@contextlib.contextmanager
def stage_timer(name: str, record: dict | None = None, device=None):
    """Host wall-clock timer for pipeline stages (reference
    Pipeline.py:98, 173-174 per-cloud timing). When the block ran on a
    CUDA device (``device``), that device is synchronized before the clock
    is read, so the time includes the work the block queued there."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        logger.info("%s: %.3fs", name, dt)
        if record is not None:
            record[name] = dt


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the block, CPU and (where there is a
    card) CUDA activities, exported as a Chrome trace
    ``{log_dir}/trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named range for traces (``torch.profiler.record_function``): shows
    on the host's timeline and, where it launched work, the device's."""
    return torch.profiler.record_function(name)
