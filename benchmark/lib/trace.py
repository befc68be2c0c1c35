"""The traced run's record: the device's operations and the host's calls in
the measured window, from PyTorch's profiler (CUPTI through kineto).

The profiler is driven through its low-level entry points so that the
window's events come back as kineto's own records, without the per-event
objects and call trees that ``torch.profiler.profile`` builds on exit (a
window of a hundred training steps holds about a million events).
:class:`Trace` keeps what the per-layer readers need: the device's
intervals by name, and the host's calls by name and interval.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


class Recorder:
    """Start with :meth:`start`, end with :meth:`stop`, which returns the
    window's :class:`Trace`."""

    def __init__(self):
        from torch.autograd import (
            ProfilerActivity,
            ProfilerConfig,
            ProfilerState,
        )
        from torch._C._profiler import _ExperimentalConfig

        self.activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False,
                                     False, False, False,
                                     _ExperimentalConfig())

    def start(self) -> None:
        from torch.autograd import _enable_profiler, _prepare_profiler

        _prepare_profiler(self.config, self.activities)
        _enable_profiler(self.config, self.activities)

    def stop(self) -> "Trace":
        from torch.autograd import DeviceType, _disable_profiler

        result = _disable_profiler()
        dev_name, dev_start, dev_end = [], [], []
        host_name, host_start, host_end = [], [], []
        for e in result.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                dev_name.append(e.name())
                dev_start.append(start)
                dev_end.append(end)
            else:
                host_name.append(e.name())
                host_start.append(start)
                host_end.append(end)
        return Trace(dev_name, np.asarray(dev_start, np.int64),
                     np.asarray(dev_end, np.int64), host_name,
                     np.asarray(host_start, np.int64),
                     np.asarray(host_end, np.int64))


@dataclass
class Trace:
    """Device operations (kernels, copies, fills) and host calls (PyTorch
    operators, CUDA runtime calls, the benchmark's spans), nanoseconds."""

    dev_name: list
    dev_start: np.ndarray
    dev_end: np.ndarray
    host_name: list
    host_start: np.ndarray
    host_end: np.ndarray
    _busy: list = field(default=None, repr=False)

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, in order."""
        if self._busy is None:
            order = np.argsort(self.dev_start, kind="stable")
            merged = []
            for s, e in zip(self.dev_start[order], self.dev_end[order]):
                if merged and s <= merged[-1][1]:
                    if e > merged[-1][1]:
                        merged[-1][1] = e
                else:
                    merged.append([int(s), int(e)])
            self._busy = [tuple(iv) for iv in merged]
        return self._busy

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_seconds(self, match) -> float:
        """Summed device time of the operations whose name ``match``
        accepts."""
        return sum(int(e - s) for n, s, e in zip(
            self.dev_name, self.dev_start, self.dev_end) if match(n)) / 1e9

    def count_host(self, names) -> int:
        """Host calls named one of ``names``."""
        wanted = set(names)
        return sum(1 for n in self.host_name if n in wanted)

    def top_device_ops(self, n: int = 10) -> list:
        """Device time by operation (:func:`short_name`), the ``n``
        largest."""
        totals: dict = {}
        for name, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            key = short_name(name)
            totals[key] = totals.get(key, 0) + int(e - s)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10, depth: int = 16) -> list:
        """Idle time between device operations, summed by the innermost
        host call that was running at each gap's midpoint (the latest to
        start among the ``depth`` before it that still runs; ``python``:
        none of them), the ``n`` largest."""
        busy = np.asarray(self.busy_intervals(), np.int64).reshape(-1, 2)
        gaps = busy[1:, 0] - busy[:-1, 1]
        mids = busy[:-1, 1] + gaps // 2
        order = np.argsort(self.host_start, kind="stable")
        h_start, h_end = self.host_start[order], self.host_end[order]
        names = np.asarray([self.host_name[i] for i in order] + ["python"],
                           dtype=object)
        last = np.searchsorted(h_start, mids, side="right") - 1
        chosen = np.full(len(mids), len(names) - 1)
        for back in range(depth - 1, -1, -1):
            idx = last - back
            ok = (idx >= 0) & (h_end[np.clip(idx, 0, None)] >= mids)
            chosen = np.where(ok, idx, chosen)
        totals: dict = {}
        for name, gap in zip(names[chosen], gaps):
            totals[name] = totals.get(name, 0) + int(gap)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[short_name(k), v / 1e9] for k, v in top]


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type, template arguments and
    parameters, at most ``limit`` characters."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    base = base.split("(")[0].split("<")[0].strip()
    return (base or name)[:limit]


def kernel_matcher(functions):
    """A name test that accepts a device operation of one of the
    ``__global__`` ``functions`` (by the name before its template
    arguments)."""
    wanted = set(functions)

    def match(name: str) -> bool:
        return short_name(name, len(name)).split("::")[-1] in wanted

    return match


def synchronize(dev) -> None:
    """Wait for the work queued on ``dev``, a CUDA device."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


class TracedPart:
    """The traced tail of a measured window of ``window_seconds``: the
    profiler runs over its last ``seconds`` (from the first step or request
    that ends after ``window_seconds - seconds``) to its end; the device is
    synchronized at either end of that part. Before it lies the untraced
    head: ``head_steps`` steps or requests in ``head_s`` seconds, which the
    host-clock readers use, free of the profiler's overhead. ``steps``,
    ``window_s`` and ``launched`` (the port's launch counts, ``launches()``
    before and after) describe the traced tail. Without a ``recorder`` it
    does nothing."""

    def __init__(self, recorder, seconds: float, window_seconds: float,
                 launches, synchronize):
        self.recorder, self.seconds = recorder, seconds
        self.window_seconds = window_seconds
        self.launches, self.synchronize = launches, synchronize
        self.trace = self.t0 = None

    def start(self) -> None:
        """At the window's start."""
        self.t_window = time.perf_counter()
        if self.recorder and self.window_seconds <= self.seconds:
            self._begin(0)

    def _begin(self, steps: int) -> None:
        self.synchronize()
        self.head_steps = steps
        self.head_s = time.perf_counter() - self.t_window
        self.before = self.launches()
        self.recorder.start()
        self.t0 = time.perf_counter()

    def done(self, steps: int, last: bool = False) -> None:
        """After each step (``steps`` done so far); ``last``: the window's
        last."""
        if not self.recorder or self.trace is not None:
            return
        if self.t0 is None:
            elapsed = time.perf_counter() - self.t_window
            if last or elapsed >= self.window_seconds - self.seconds:
                self._begin(steps)
        if not last:
            return
        self.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.trace = self.recorder.stop()
        self.steps = steps - self.head_steps
        self.launched = {k: v - self.before.get(k, 0)
                         for k, v in self.launches().items()}
