"""How much of the host a window had, for a host-bound cell's standard
error: the share of the machine's CPU time its hypervisor stole
(``/proc/stat``), the process's involuntary context switches, the time
Python's collector ran, and the steps done in each slice of the window.
No metric reads them; they say why a run's rate reads low."""

from __future__ import annotations

import gc
import resource
import time
from typing import List


def _cpu_jiffies():
    try:
        with open("/proc/stat") as f:
            fields = [int(v) for v in f.readline().split()[1:]]
    except OSError:
        return None
    return sum(fields[:8]), fields[7]            # all, steal


class HostMeter:
    def __init__(self, slice_s: float = 5.0):
        self.slice_s = slice_s
        self.steps: List[float] = []
        self.gc_s, self.gc_runs, self._gc_tic = 0.0, 0, None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_tic = time.perf_counter()
        elif self._gc_tic is not None:
            self.gc_s += time.perf_counter() - self._gc_tic
            self.gc_runs += 1

    def __enter__(self):
        self.tic = time.perf_counter()
        self._cpu = _cpu_jiffies()
        self._nivcsw = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
        gc.callbacks.append(self._on_gc)
        return self

    def step(self):
        self.steps.append(time.perf_counter())

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        self.wall = time.perf_counter() - self.tic
        cpu = _cpu_jiffies()
        self.steal = (None if cpu is None or self._cpu is None else
                      (cpu[1] - self._cpu[1]) / max(cpu[0] - self._cpu[0], 1))
        self.nivcsw = (resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
                       - self._nivcsw)

    def line(self) -> str:
        n = max(1, int(self.wall // self.slice_s))
        per = [0] * n
        for t in self.steps:
            per[min(n - 1, int((t - self.tic) // self.slice_s))] += 1
        steal = ("not read" if self.steal is None
                 else f"{100 * self.steal:.2f} %")
        return (f"host: steps per {self.slice_s:g} s {per}; steal {steal}; "
                f"involuntary switches {self.nivcsw}; gc {self.gc_runs} runs "
                f"{self.gc_s * 1e3:.1f} ms")
