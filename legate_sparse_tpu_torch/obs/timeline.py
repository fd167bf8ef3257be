# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The program's spans on the device's timeline: a ``torch.profiler``
trace joined to ``obs``'s span records.

The profiler stamps its events in microseconds from its trace's start;
``obs`` stamps its records with ``trace.clock_ns``.  ``anchor(device)``
records spans ``obs.anchor``, each around one ``torch.cuda.synchronize``,
a call the profiler records too (``cudaDeviceSynchronize``).  Each
such pair reads the offset between the two clocks as the difference of
the two intervals' midpoints, wrong by at most half the span's time
outside the call (its bound); the tightest of the opening anchors
gives the offset (``Timeline.offset_us``, ``.offset_bound_us``).
Closing anchors read it again: the two readings differ by
``Timeline.skew_us``, what the clocks drift apart over the trace plus
the error of both.

``join(records, events)`` then gives each device operation (kernel,
copy, set) the stack of spans open when the runtime call that launched
it started (the call and the operation share the profiler's
correlation id), and each idle gap of the device, between two of its
operations, the stack open at the gap's midpoint: a gap with no span
open is ``no span``.  The innermost span names the operation or gap
(with its ``level`` attribute, where it has one: ``gmg.level@0``).

``Slice(device)`` is a traced slice that does all of it: the profiler
with the device's activity alone (host operators would slow a
launch-bound loop), ``obs`` tracing on, anchors at each end, the
records made in between joined, and the ``obs`` counters and ``lat.*``
histograms read before and after.  Nothing here is imported by the hot paths; the
slice's anchors are the only device synchronisations in ``obs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import counters as _counters
from . import latency as _latency
from . import trace as _trace

ANCHOR = "obs.anchor"
ANCHOR_REPEATS = 3
SYNC_CALL = "cudaDeviceSynchronize"
NO_SPAN = "no span"
# Runtime calls that launch a kernel: each has a device operation of
# its correlation id, unless the profiler dropped that record.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


@dataclass(frozen=True)
class Event:
    """One profiler event: a runtime call on the host (``device``
    False) or an operation on the device, in the profiler's
    microseconds, with its correlation id."""
    name: str
    start_us: float
    end_us: float
    corr: int
    device: bool


@dataclass(frozen=True)
class SpanIv:
    """A span record on the profiler's clock."""
    name: str
    start_us: float
    end_us: float
    attrs: Dict

    @property
    def label(self) -> str:
        level = self.attrs.get("level")
        return self.name if level is None else f"{self.name}@{level}"


@dataclass
class Timeline:
    """Spans, device operations, idle gaps and the host's runtime calls
    on one clock.  ``ops``, ``gaps`` and ``calls`` are ``(name or None,
    start_us, end_us, stack)`` with ``stack`` the indices into
    ``spans`` of the spans open (at a call's or a launch's start, at a
    gap's midpoint), outermost first.  ``launches`` counts the kernel
    launches on the host and ``lost`` those of them with no device
    operation in the trace: device records the profiler dropped."""
    spans: List[SpanIv]
    ops: List[Tuple[str, float, float, Tuple[int, ...]]]
    gaps: List[Tuple[None, float, float, Tuple[int, ...]]]
    offset_us: float
    offset_bound_us: float
    skew_us: Optional[float] = None
    counters: Dict[str, float] = field(default_factory=dict)
    histograms: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    calls: List[Tuple[str, float, float, Tuple[int, ...]]] = field(
        default_factory=list)
    launches: int = 0
    lost: int = 0

    def _innermost(self, stack: Tuple[int, ...]) -> str:
        return self.spans[stack[-1]].label if stack else NO_SPAN

    @staticmethod
    def _top(totals: Dict[str, float], top: int) -> List[list]:
        rows = sorted(totals.items(), key=lambda r: -r[1])[:top]
        return [[name, seconds] for name, seconds in rows]

    def device_by_span(self, top: int = 10) -> List[list]:
        """Device seconds by innermost span, the ``top`` largest."""
        out: Dict[str, float] = {}
        for _, s, e, stack in self.ops:
            key = self._innermost(stack)
            out[key] = out.get(key, 0.0) + (e - s) * 1e-6
        return self._top(out, top)

    def idle_by_span(self, top: int = 10) -> List[list]:
        """Idle seconds of the device by the innermost span open at
        each gap's midpoint, the ``top`` largest."""
        out: Dict[str, float] = {}
        for _, s, e, stack in self.gaps:
            key = self._innermost(stack)
            out[key] = out.get(key, 0.0) + (e - s) * 1e-6
        return self._top(out, top)

    def busy_s(self) -> float:
        """Seconds with a device operation running: the union of the
        operations' intervals (the gaps' complement)."""
        if not self.ops:
            return 0.0
        first = min(s for _, s, _, _ in self.ops)
        last = max(e for _, _, e, _ in self.ops)
        return (last - first - sum(e - s for _, s, e, _ in self.gaps)) * 1e-6

    def count(self, name: str) -> int:
        """The spans named ``name``."""
        return sum(1 for sp in self.spans if sp.name == name)

    def span_seconds(self, name: str) -> float:
        """The summed length of the spans named ``name``."""
        return sum(sp.end_us - sp.start_us for sp in self.spans
                   if sp.name == name) * 1e-6

    def host_seconds(self, name: str) -> float:
        """The summed length of the spans named ``name`` (none inside
        another) less the runtime calls made inside them: the host's
        own time there, without what it waited inside a launch (a full
        launch queue), a copy or a synchronisation."""
        waited = sum(e - s for _, s, e, stack in self.calls
                     if any(self.spans[i].name == name for i in stack))
        return self.span_seconds(name) - waited * 1e-6

    def device_seconds(self, within: str,
                       outside: Sequence[str] = ()) -> float:
        """Device seconds of the operations launched inside a span
        named ``within`` and inside none named in ``outside``."""
        total = 0.0
        for _, s, e, stack in self.ops:
            names = {self.spans[i].name for i in stack}
            if within in names and not names.intersection(outside):
                total += (e - s) * 1e-6
        return total

    def device_seconds_by(self, name: str, attr: str) -> Dict:
        """Device seconds of the operations launched inside a span
        named ``name``, by the ``attr`` of the innermost such span."""
        out: Dict = {}
        for _, s, e, stack in self.ops:
            for i in reversed(stack):
                sp = self.spans[i]
                if sp.name == name:
                    key = sp.attrs.get(attr)
                    out[key] = out.get(key, 0.0) + (e - s) * 1e-6
                    break
        return out


def from_profiler(events: Iterable) -> List[Event]:
    """``Event``s from ``torch.profiler``'s ``events()``: the device's
    operations and the host's CUDA API calls (names ``cu*``);
    operators and annotations are left out."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        device = e.device_type == DeviceType.CUDA
        if not device and not e.name.startswith("cu"):
            continue
        out.append(Event(e.name, float(e.time_range.start),
                         float(e.time_range.end), int(e.id), device))
    return out


def _reading(rec: Dict, ev: Event) -> Tuple[float, float]:
    """``(offset, bound)`` of an anchor span against the
    synchronisation it holds: the difference of the midpoints, and
    half the span's time outside the call, which bounds its error."""
    span_us = rec["dur_ns"] * 1e-3
    mid = rec["ts_ns"] * 1e-3 + 0.5 * span_us
    return (mid - 0.5 * (ev.start_us + ev.end_us),
            0.5 * max(span_us - (ev.end_us - ev.start_us), 0.0))


def _anchor_readings(records: Sequence[Dict], events: Sequence[Event]
                     ) -> List[Tuple[float, float]]:
    """The best ``(offset, bound)`` (the least bound) of the opening
    anchors and, where there are closing ones, of those.  The opening
    anchors hold the trace's first ``cudaDeviceSynchronize`` calls, in
    order; a closing anchor holds the call that lies inside it under
    the opening offset."""
    anchors = sorted((r for r in records
                      if r.get("type") == "span" and r["name"] == ANCHOR),
                     key=lambda r: r["ts_ns"])
    opening = [r for r in anchors
               if (r.get("attrs") or {}).get("at") != "close"]
    closing = [r for r in anchors
               if (r.get("attrs") or {}).get("at") == "close"]
    syncs = sorted((e for e in events
                    if not e.device and e.name == SYNC_CALL),
                   key=lambda e: e.start_us)
    if not opening or not syncs:
        raise ValueError("no anchor: a span obs.anchor around a "
                         "torch.cuda.synchronize() at the start of the "
                         "profiled interval is needed to join the clocks")
    first = min((_reading(r, e) for r, e in zip(opening, syncs)),
                key=lambda rb: rb[1])
    out = [first]
    off, slack = first
    found = []
    for r in closing:
        lo = r["ts_ns"] * 1e-3 - off - slack
        hi = (r["ts_ns"] + r["dur_ns"]) * 1e-3 - off + slack
        found += [_reading(r, e) for e in syncs
                  if e.start_us >= lo and e.end_us <= hi]
    if found:
        out.append(min(found, key=lambda rb: rb[1]))
    return out


def _stacks(spans: Sequence[SpanIv],
            times: Sequence[float]) -> List[Tuple[int, ...]]:
    """For each time, the indices of the spans open at it (start <= t
    <= end), outermost first: one sweep over the span edges."""
    edges = []
    for i, sp in enumerate(spans):
        edges.append((sp.start_us, 0, i))
        edges.append((sp.end_us, 2, i))
    edges.extend((t, 1, k) for k, t in enumerate(times))
    # Opens before queries before closes at one instant; a longer span
    # opens first (it holds the shorter).
    edges.sort(key=lambda e: (e[0], e[1],
                              -(spans[e[2]].end_us if e[1] == 0 else 0)))
    stack: List[int] = []
    out: List[Tuple[int, ...]] = [()] * len(times)
    for _, kind, i in edges:
        if kind == 0:
            stack.append(i)
        elif kind == 1:
            out[i] = tuple(stack)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
    return out


def join(records: Sequence[Dict], events: Sequence[Event]) -> Timeline:
    """The ``Timeline`` of ``records`` (``obs.records()``, with their
    anchors) over ``events`` (``from_profiler``)."""
    readings = _anchor_readings(records, events)
    offset, bound = readings[0]
    skew = readings[1][0] - offset if len(readings) > 1 else None
    spans = [SpanIv(r["name"], r["ts_ns"] * 1e-3 - offset,
                    (r["ts_ns"] + r["dur_ns"]) * 1e-3 - offset,
                    r.get("attrs") or {})
             for r in records if r.get("type") == "span"]
    host = sorted((e for e in events if not e.device),
                  key=lambda e: e.start_us)
    device = sorted((e for e in events if e.device),
                    key=lambda e: e.start_us)
    gaps = []
    cur_end = None
    for e in device:
        if cur_end is not None and e.start_us > cur_end:
            gaps.append((cur_end, e.start_us))
        cur_end = e.end_us if cur_end is None else max(cur_end, e.end_us)
    # An operation whose launch the trace lacks is placed at its own
    # start.
    launched = {e.corr for e in host}
    orphans = [e for e in device if e.corr not in launched]
    stacks = _stacks(spans, [e.start_us for e in host]
                     + [0.5 * (s + e) for s, e in gaps]
                     + [e.start_us for e in orphans])
    calls = [(e.name, e.start_us, e.end_us, stacks[k])
             for k, e in enumerate(host)]
    ran = {e.corr for e in device}
    launches = [e for e in host if e.name in LAUNCH_CALLS]
    at_call = {e.corr: stacks[k] for k, e in enumerate(host)}
    at_orphan = {id(e): stacks[len(host) + len(gaps) + k]
                 for k, e in enumerate(orphans)}
    ops = [(e.name, e.start_us, e.end_us,
            at_call[e.corr] if e.corr in at_call else at_orphan[id(e)])
           for e in device]
    gap_rows = [(None, s, e, stacks[len(host) + k])
                for k, (s, e) in enumerate(gaps)]
    return Timeline(spans=spans, ops=ops, gaps=gap_rows, offset_us=offset,
                    offset_bound_us=bound, skew_us=skew, calls=calls,
                    launches=len(launches),
                    lost=sum(1 for e in launches if e.corr not in ran))


def anchor(device, at: str = "open") -> None:
    """``ANCHOR_REPEATS`` times ``torch.cuda.synchronize(device)``, each
    inside a span ``obs.anchor`` (attribute ``at``: ``open`` or
    ``close``): points both clocks record (tracing must be on).  The
    tightest of them gives the offset: a host stall inside one (the
    profiler's first buffer request, ~3 ms on an H100) only widens
    that one."""
    import torch

    for _ in range(ANCHOR_REPEATS):
        with _trace.span("obs.anchor", at=at):
            torch.cuda.synchronize(device)


def _histograms(prefix: str) -> Dict[str, Tuple[int, float]]:
    return {name: (h.count, h.sum)
            for name, h in _latency.snapshot(prefix).items()}


def delta(after: Dict, before: Dict) -> Dict:
    """``after`` less ``before``, name by name (numbers, or
    ``(count, sum)`` pairs), where it moved."""
    out = {}
    for name, v in after.items():
        w = before.get(name)
        if isinstance(v, tuple):
            w = w or (0, 0.0)
            d = (v[0] - w[0], v[1] - w[1])
            if d[0]:
                out[name] = d
        else:
            d = v - (w or 0)
            if d:
                out[name] = d
    return out


class Slice:
    """``with Slice(device) as s: ...``; then ``s.timeline``: the body
    under ``torch.profiler`` (the device's activity alone) with ``obs``
    tracing on (its state before is restored after), between two
    anchors, and the counters and ``lat.*`` histograms that moved in
    it (``Timeline.counters``, ``.histograms``: ``(count, sum ms)``).
    The timeline joins only the records made inside the slice; those
    made before it, and the per-name sequence numbers, are left as they
    were, and the slice's own records stay in the buffer after them.
    ``wall_s`` is the host's time from the first anchor's end to the
    second's end.  On a device that is not a card the body runs
    untraced and ``timeline`` stays None."""

    def __init__(self, device):
        self.device = device
        self.timeline: Optional[Timeline] = None
        self.wall_s = 0.0
        self._prof = None

    def __enter__(self):
        if getattr(self.device, "type", None) != "cuda":
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._was_on = _trace.enabled()
        self._mark = _trace.mark()
        _trace.enable()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._c0 = _counters.snapshot()
        self._h0 = _histograms("lat.")
        anchor(self.device)
        self._t0 = _trace.clock_ns()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        try:
            anchor(self.device, at="close")
            self.wall_s = (_trace.clock_ns() - self._t0) * 1e-9
            c1 = _counters.snapshot()
            h1 = _histograms("lat.")
        finally:
            self._prof.__exit__(*exc)
            if not self._was_on:
                _trace.disable()
        if exc[0] is None:
            tl = join(_trace.records(self._mark),
                      from_profiler(self._prof.events()))
            tl.counters = delta(c1, self._c0)
            tl.histograms = delta(h1, self._h0)
            self.timeline = tl
        return False
