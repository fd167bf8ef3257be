"""What every traffic mix shares: inputs drawn from the seed, the sample
of answers, and the window with its fences.

A mix is a data file, ``traffic/<mix>.json``; its ``kind`` names the
generator that reads it, ``kinds/<kind>.py``, whose ``Mix`` subclasses
``Mix`` here.  A kind supplies three things:

- ``prepare(A, M)``: the mix's inputs and the warm-up of its own shapes;
- ``step(w)``: one unit of the window's work (a solve, a product),
  counted in ``w.count``;
- ``profiled(w)``: the traced slice, run once from the first unit after
  half the window (``profile.Slice`` around the kind's own units);

and ``checks(ref, wanted, w, control)``: the numbers compared after
the window.
The window (``Mix.run``) starts and ends in a device synchronisation
and ends with the unit in flight at ``seconds``, so every unit is whole
and every second is counted.

Answers are kept by ``Reservoir``: a uniform sample over all answers of
the window, drawn from the seed, copied into buffers made in set-up.
"""

from __future__ import annotations

import hashlib
import math
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from . import profile as _profile


def derive(seed: int, *parts) -> int:
    """A 63-bit seed from the run's seed and ``parts``."""
    h = hashlib.blake2b(":".join(str(p) for p in (seed,) + parts).encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def uniform(n: int, bounds: dict, seed: int, dtype, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    t = torch.rand(n, generator=g, dtype=torch.float32, device=device)
    lo, hi = float(bounds["low"]), float(bounds["high"])
    return (t * (hi - lo) + lo).to(dtype)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|``, in float64."""
    want = want.to(torch.float64)
    diff = (got.to(torch.float64) - want).abs().max()
    return float(diff / want.abs().max())


def worst(values) -> float:
    """The largest value; NaN where any value is NaN."""
    out = -math.inf
    for v in values:
        if math.isnan(v):
            return v
        out = max(out, v)
    return out


class Reservoir:
    """A uniform sample of ``k`` answers over all offered, each a tuple
    of tensors copied into buffers allocated before the window."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.bufs: List[Tuple[torch.Tensor, ...]] = []
        self.index: List[int] = []

    def prepare(self, *like: torch.Tensor) -> None:
        self.bufs = [tuple(torch.empty_like(t) for t in like)
                     for _ in range(self.k)]

    def offer(self, i: int, *ts: torch.Tensor) -> None:
        if i < self.k:
            slot = i
            self.index.append(i)
        else:
            slot = self.rng.randrange(i + 1)
            if slot >= self.k:
                return
            self.index[slot] = i
        for buf, t in zip(self.bufs[slot], ts):
            buf.copy_(t)

    def items(self) -> List[Tuple[int, Tuple[torch.Tensor, ...]]]:
        return list(zip(self.index, self.bufs))


@dataclass
class Window:
    wall_s: float = 0.0
    count: int = 0
    iters: List[int] = field(default_factory=list)
    unconverged: List[int] = field(default_factory=list)
    trace: Optional[_profile.Trace] = None
    slice_iters: int = 0
    vcycle_s: List[float] = field(default_factory=list)


# The numbers compared after a window: for each number's name, its
# reading on each answer checked, by the answer's number.  The number
# compared is the worst reading; an answer is wrong where any of its
# readings passes that number's limit.
Checks = Dict[str, Dict[int, float]]


class Mix:
    """A traffic mix bound to a configuration, its operator's rows, the
    value type and a seed."""

    def __init__(self, mix: dict, config: dict, rows: int,
                 device: torch.device, dtype: torch.dtype, seed: int):
        self.mix = mix
        self.config = config
        self.n = rows
        self.device = device
        self.dtype = dtype
        self.seed = seed
        self.sample = Reservoir(int(mix["sample"]), derive(seed, "sample"))

    def prepare(self, A, M=None) -> None:
        raise NotImplementedError

    def step(self, w: Window) -> None:
        raise NotImplementedError

    def profiled(self, w: Window) -> None:
        raise NotImplementedError

    def checks(self, ref, wanted, w: Window, control: bool = False) -> Checks:
        """The numbers named in ``wanted`` that the kind can read, on
        the window ``w``, against ``ref`` (the configuration's
        reference).  With ``control`` the reference, in bfloat16, takes
        the program's place: only the numbers that compare an answer
        are read."""
        raise NotImplementedError

    def run(self, A, M, seconds: float, trace: bool) -> Window:
        """The window: units back to back from a device synchronisation
        until the unit in flight at ``seconds`` ends, then a device
        synchronisation; with ``trace``, the profiled slice once from
        the first unit after half the window."""
        self.A, self.M = A, M
        w = Window()
        sliced = not trace
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            if not sliced and time.perf_counter() - t0 >= seconds / 2:
                self.profiled(w)
                sliced = True
            else:
                self.step(w)
            if sliced and time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        w.wall_s = time.perf_counter() - t0
        self.release()
        return w

    def release(self) -> None:
        """Drop what the mix holds of the program's state, so that it
        can be freed before the comparison."""
        self.A = self.M = None
