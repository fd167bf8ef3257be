"""``matvec``: products ``y = A @ x_k`` dispatched back to back.

Mix parameters: ``vectors`` (how many x_k, cycled over), ``x`` (their
bounds: uniform in [low, high) from the seed), ``sample`` (answers kept
for the comparison) and ``profile.seconds`` (the traced slice's length).

The window ends in a device synchronisation after the product in
flight at its length.  Checked after it: ``max_rel_err``, the widest
gap of a sampled product from the reference's, ``max |y - y_ref| /
max |y_ref|`` with the reference in float64.
"""

from __future__ import annotations

import time
from typing import List

import torch

from ..core import profile as _profile
from ..core import system
from ..core.traffic import Checks, Mix as _Mix, Window, derive, rel_err
from ..core.traffic import uniform


class Mix(_Mix):
    xs: List[torch.Tensor]

    def vector(self, k: int) -> torch.Tensor:
        return uniform(self.n, self.mix["x"], derive(self.seed, "x", k),
                       self.dtype, self.device)

    def prepare(self, A, M=None) -> None:
        self.xs = [self.vector(k) for k in range(int(self.mix["vectors"]))]
        self.sample.prepare(system.matvec(A, self.xs[0]))

    def _one(self, w: Window) -> None:
        i = w.count
        self.sample.offer(i, system.matvec(self.A, self.xs[i % len(self.xs)]))
        w.count += 1

    def step(self, w: Window) -> None:
        self._one(w)

    def profiled(self, w: Window) -> None:
        span = float(self.mix["profile"]["seconds"])
        with _profile.Slice(self.device) as sl:
            t1 = time.perf_counter()
            while True:
                self._one(w)
                if time.perf_counter() - t1 >= span:
                    break
        w.trace = sl.trace

    def checks(self, ref, wanted, w: Window, control: bool = False) -> Checks:
        gaps = {}
        for i, (got,) in self.sample.items():
            x = self.xs[i % len(self.xs)]
            want = ref.apply(x)
            if control:
                got = ref.apply(x, torch.bfloat16)
            gaps[i] = rel_err(got, want)
        return {"max_rel_err": gaps}
