"""The device trace of the profiled sub-window, reduced: every kernel's
interval, the benchmark's own host ranges (`bench.<call>`), the busy
union, the idle gaps by what the host was doing, and the kernels that took
most of the time."""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

HOST_LOOP = "host: server event loop"
SHORT_GAP = "launch gaps under 10 us"
SHORT_GAP_S = 10e-6


@dataclasses.dataclass
class Trace:
    window_s: float
    kernels: List[Tuple[str, float, float]]      # (name, start s, end s)
    ranges: List[Tuple[str, float, float]]       # bench.* host ranges

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the kernels whose name contains one of
        `names`."""
        return sum(e - s for n, s, e in self.kernels
                   if any(x in n for x in names))

    def busy(self, kernels=None) -> List[Tuple[float, float]]:
        """The union of the kernels' intervals (by default all of them)."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.kernels if kernels is None else kernels,
                              key=lambda k: k[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def calls_busy_s(self, name: str) -> Tuple[int, float]:
        """(calls, device seconds) of the benchmark's `bench.<name>` ranges:
        for each, the union of the kernels that ran inside it. Every
        replica call ends in a device synchronize, so its kernels start
        and end inside its host range; the range's idle gaps (input copies,
        output reads) are not counted."""
        ks = sorted(self.kernels, key=lambda k: k[1])
        starts = [k[1] for k in ks]
        n, tot = 0, 0.0
        for rn, a, b in self.ranges:
            if rn != f"bench.{name}":
                continue
            inside = ks[bisect.bisect_left(starts, a):
                        bisect.bisect_right(starts, b)]
            n += 1
            tot += sum(e - s for s, e in self.busy(
                [k for k in inside if k[2] <= b]))
        return n, tot

    def top_kernels(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for n, s, e in self.kernels:
            tot[n[:96]] = tot.get(n[:96], 0.0) + (e - s)
        return [[n, v] for n, v in sorted(tot.items(),
                                           key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle device time between kernels, summed by what the host was
        doing: gaps under SHORT_GAP_S are the launch gaps inside a call;
        a longer gap is labeled by the `bench.*` call its middle falls in,
        else it is the server's event loop between calls."""
        starts = sorted(self.ranges, key=lambda r: r[1])
        keys = [r[1] for r in starts]
        tot: Dict[str, float] = {}
        busy = self.busy()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            if b - a < SHORT_GAP_S:
                label = SHORT_GAP
            else:
                mid = 0.5 * (a + b)
                i = bisect.bisect_right(keys, mid) - 1
                label = (starts[i][0] if i >= 0 and starts[i][2] >= mid
                         else HOST_LOOP)
            tot[label] = tot.get(label, 0.0) + (b - a)
        return [[n, v] for n, v in sorted(tot.items(),
                                           key=lambda x: -x[1])[:k]]


def read(prof, window_s: float) -> Optional[Trace]:
    """The stopped profiler's kernels and ranges, or None when it saw no
    device activity."""
    import torch
    kernels, ranges = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("bench."):
            # the host range, and its copy on the device's timeline (a
            # user annotation, not a kernel)
            if e.device_type != torch.autograd.DeviceType.CUDA:
                ranges.append((e.name, tr.start / 1e6, tr.end / 1e6))
        elif (e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)):
            kernels.append((e.name, tr.start / 1e6, tr.end / 1e6))
    if not kernels:
        return None
    return Trace(window_s, kernels, ranges)
