"""The traced stretch: ``torch.profiler`` over a steady stretch of the
cell's own calls, reduced to what the per-layer readers and the result
line take:

* the device's records (kernels, copies, sets) as intervals, their union
  (``busy_s``), their summed time by name;
* the host's records (runtime calls such as ``cudaGraphLaunch``, the
  operators around them) with their durations;
* the stretch's length by the host clock, from a synchronised start to a
  synchronised end (``window_s``);
* the longest idle gaps of the device, each named by the innermost host
  record that covers its middle.

The raw records are read from the profiler's Kineto results, without
building its per-event Python tree.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10


@dataclass
class TraceData:
    window_s: float
    device: List[Tuple[str, int, int]]  # (name, start ns, end ns)
    host: List[Tuple[str, int, int]]
    units: int = 0  # timed units (steps, requests) in the stretch
    spans: Dict[str, List[float]] = field(default_factory=dict)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def device_time_by_name(self) -> Dict[str, float]:
        acc: Dict[str, float] = {}
        for name, a, b in self.device:
            acc[name] = acc.get(name, 0.0) + (b - a) / 1e9
        return acc

    def host_time(self, name: str) -> Tuple[int, float]:
        """(count, summed seconds) of the host records named ``name``."""
        d = [(b - a) for n, a, b in self.host if n == name]
        return len(d), sum(d) / 1e9

    def breakdown(self) -> Dict[str, List]:
        ops = sorted(self.device_time_by_name().items(),
                     key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])
                       if a1 > b0), key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            cover = [h for h in self.host if h[1] <= mid <= h[2]]
            what = (max(cover, key=lambda h: h[1])[0] if cover
                    else "no host record")
            named.append([short(what), (b - a) / 1e9])
        return {"device_ops": [[short(n), s] for n, s in ops],
                "idle_gaps": named}


def short(name: str, n: int = 120) -> str:
    name = " ".join(name.split())
    return name if len(name) <= n else name[:n - 3] + "..."


class Traced:
    """``with Traced() as tr: ...`` profiles the block; ``tr.data`` holds
    the reduced records. The block's start and end are synchronised."""

    def __init__(self):
        self.data: Optional[TraceData] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self._cuda else [])
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def _sync(self):
        if self._cuda:
            torch.cuda.synchronize()

    def __exit__(self, *exc):
        self._sync()
        window = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append(rec)
            else:
                host.append(rec)
        self.data = TraceData(window_s=window, device=dev, host=host)
        return False
