"""What the host did during a window, read beside the metrics to find what
makes runs spread: the process's CPU seconds against the wall clock, its
involuntary context switches (other work on the host's cores taking them
from it), Python's garbage collections and their seconds, and the host's
load average. Nothing here waits for the device."""

from __future__ import annotations

import gc
import os
import resource
import time


class HostWatch:
    """:meth:`start` at the window's start, :meth:`stop` at its end;
    :meth:`stop` returns the readings."""

    def __init__(self):
        self.collections, self.gc_s, self._t = [0, 0, 0], 0.0, None

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.collections[info["generation"]] += 1
            self._t = None

    def start(self) -> None:
        self.usage = resource.getrusage(resource.RUSAGE_SELF)
        self.wall = time.perf_counter()
        self.load = os.getloadavg()[0]
        gc.callbacks.append(self._on_gc)

    def stop(self) -> dict:
        gc.callbacks.remove(self._on_gc)
        usage = resource.getrusage(resource.RUSAGE_SELF)
        wall = time.perf_counter() - self.wall
        cpu = (usage.ru_utime - self.usage.ru_utime
               + usage.ru_stime - self.usage.ru_stime)
        return {
            "cpu_per_wall": cpu / wall,
            "involuntary_switches_per_s":
                (usage.ru_nivcsw - self.usage.ru_nivcsw) / wall,
            "gc_collections": list(self.collections),
            "gc_s": self.gc_s,
            "load_1min": [self.load, os.getloadavg()[0]],
            "cores": len(os.sched_getaffinity(0)),
        }
