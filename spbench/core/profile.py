"""The traced slice: ``torch.profiler`` over a steady part of the
window, reduced in memory to what the per-layer readers take.

The profiler records the device's activity alone (CUDA activity: the
kernels, copies and sets, and the CUDA runtime calls that launched
them).  Recording the host's operators too slows a launch-bound loop
by a third (a GMG V-cycle: 6.92 ms against 5.16-5.68 untraced, 5.37
with the device's activity alone, on the H100), which would read as
idle device time that the untraced run does not have.  The slice
starts and ends in a device synchronisation, so it holds every device
operation it launched; its length is taken by the host clock between
the two.  From its events:

- the busy time: the union of the device's kernel, copy and set
  intervals, as the profiler's clock reads them (not cut to the
  slice's length: a busy time over it shows a fault of the reading);
- per kernel name, its launches and device seconds;
- the kernel launches (copies and sets left out);
- the idle gaps, each named by the CUDA runtime call that the host was
  in at its middle, or ``host (between CUDA calls)`` where it was in
  none (Python and the operators' dispatch); the slice's head and tail
  outside the device's first and last operation are ``slice edges``.

No trace file is written.  On the CPU there is no device to trace, and
the slice reads nothing.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

NOT_KERNELS = ("Memcpy", "Memset")
BETWEEN = "host (between CUDA calls)"
EDGES = "slice edges"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]   # name -> (launches, seconds)
    launches: int
    idle: Dict[str, float]                  # host label -> idle seconds

    def matching(self, part: str) -> Tuple[int, float]:
        """Launches and device seconds of the kernels whose name holds
        ``part``."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if part in name:
                n += c
                s += t
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((name, t) for name, (_, t) in self.kernels.items()),
                     key=lambda r: -r[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda r: -r[1])[:top]
        return {"device_ops": [[name[:120], t] for name, t in ops],
                "idle_gaps": [[name[:120], t] for name, t in gaps]}


def warm(device: torch.device, fn: Callable[[], None]) -> None:
    """``fn`` (the cell's warm-up) under the profiler: the profiler's
    one-off start-up and its first sight of each kernel stay in set-up,
    out of the slice."""
    if device.type != "cuda":
        fn()
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize(device)


class Slice:
    """``with Slice(device) as s: ...``; then ``s.trace`` (None where
    the device is not a card: a CPU run has no device metric)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.trace: Optional[Trace] = None
        self._prof = None

    def __enter__(self):
        if self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize(self.device)
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            torch.cuda.synchronize(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        try:
            torch.cuda.synchronize(self.device)
            window_s = time.perf_counter() - self._t0
        finally:
            self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = reduce_events(self._prof.events(), window_s)
        return False


def reduce_events(events, window_s: float) -> Trace:
    """The slice's ``Trace`` from the profiler's events and its length
    by the host clock."""
    from torch.autograd import DeviceType

    device_iv: List[Tuple[float, float]] = []
    kernels: Dict[str, List[float]] = {}
    launches = 0
    host: List[Tuple[float, float, str]] = []
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            device_iv.append((start, end))
            if not e.name.startswith(NOT_KERNELS):
                launches += 1
                rec = kernels.setdefault(e.name, [0, 0.0])
                rec[0] += 1
                rec[1] += (end - start) * 1e-6
        else:
            host.append((start, end, e.name))
    device_iv.sort()
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}

    def gap(a, b):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        label = host[i][2] if i >= 0 and host[i][1] >= mid else BETWEEN
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6

    busy = 0.0
    span = 0.0
    if device_iv:
        cur_s, cur_e = device_iv[0]
        for s, e in device_iv[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gap(cur_e, s)
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        span = (cur_e - device_iv[0][0]) * 1e-6
    busy_s = busy * 1e-6
    if window_s > span:
        idle[EDGES] = window_s - span
    return Trace(window_s=window_s, busy_s=busy_s,
                 kernels={k: (int(v[0]), v[1]) for k, v in kernels.items()},
                 launches=launches, idle=idle)
