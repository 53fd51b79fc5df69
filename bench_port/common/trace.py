"""Device trace of a short steady window, read into busy time, idle share,
kernel time by name and the idle gaps by what the host was doing.

After ``chip_smoke.py::graph_replay_profile`` (sound on the card): the
window is ``torch.profiler`` with CPU and CUDA activities between two
synchronisations. The profiler now and then loses kernel events (which
only lowers counts and busy time), so a driver traces several windows
and keeps the one with the most device events. Busy time is the union of the device
activities' intervals (kernels, copies, fills), not their sum, and the
window's length is the trace's own span, first event to last, on the
profiler's clock: another thread's kernel already running when tracing
starts (a serving worker's) then lies inside it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch


@dataclass
class Window:
    wall_s: float
    device: List[Tuple[str, float, float]]    # (name, start_us, end_us)
    host: List[Tuple[str, float, float]]
    counts: Dict[str, float] = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        total, end = 0.0, None
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.wall_s

    @staticmethod
    def span_s(rows) -> float:
        return (max(e for _, _, e in rows) - min(s for _, s, _ in rows)) / 1e6

    def kernel_s(self, names) -> Tuple[float, int]:
        """Seconds and count of the device events whose name contains one
        of ``names``."""
        hit = [e - s for n, s, e in self.device if any(k in n for k in names)]
        return sum(hit) / 1e6, len(hit)

    def top_ops(self, n=10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name[:96]] = by.get(name[:96], 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n=10, longest=300) -> List[list]:
        """The device's ``longest`` idle gaps between activities, summed by
        the innermost host operation running at each gap's middle ("host
        idle" where none), largest first."""
        import bisect

        dev = sorted(self.device, key=lambda r: r[1])
        host = sorted(self.host, key=lambda r: r[1])
        starts = [h[1] for h in host]
        gaps = []
        end = dev[0][2] if dev else None
        for _, s, e in dev[1:]:
            if s > end:
                gaps.append((s - end, (s + end) / 2))
            end = max(end, e)
        by: Dict[str, float] = {}
        for length, mid in sorted(gaps, reverse=True)[:longest]:
            label = "host idle"
            # the latest-starting host op that still runs at ``mid``
            for i in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 4000),
                           -1):
                if host[i][2] >= mid:
                    label = host[i][0][:96]
                    break
            by[label] = by.get(label, 0.0) + length / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def _device_kind(evt) -> bool:
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CUDA


def profile(run: Callable[[], Dict[str, float]]) -> Window:
    """Trace ``run``, which does the window's work and returns its
    counts."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else (lambda: None))
    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        counts = run()
        sync()
        wall = time.perf_counter() - tic
    dev, host = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end)
        (dev if _device_kind(e) else host).append(row)
    return Window(Window.span_s(dev + host) if dev else wall, dev, host,
                  counts)
