"""``solve``: solves one after another, each of ``A x = b_i`` from
x0 = 0, by the program's solver that the mix names.

Mix parameters:

- ``solver``: ``name`` (a solver of the program's ``linalg``) and its
  keyword arguments (``rtol``, ``maxiter``, ...), passed as they are;
- ``warmup_maxiter``: the iterations of the warm-up solve in set-up;
- ``rhs``: the bounds of ``b_i``, uniform in [low, high), drawn afresh
  for every solve from the seed and the solve's number;
- ``preconditioner`` (optional): ``name`` (``preconditioners/<name>.py``
  builds it, ``reference/<name>.py`` is its plain reference) and its
  parameters;
- ``sample``: solves kept for the comparison; ``precond_sample``:
  applications of the preconditioner kept, ``(r, M r)``;
- ``profile.solves``: whole solves in the traced slice.  With a
  preconditioner, as many solves after the slice time each of its
  applications by CUDA events, unprofiled (the profiler slows a
  launch-bound loop).

The window ends when the solve in flight at its length ends.  Checked
after it, each where the cell's limits name it:

- ``max_rel_err``: the widest gap of a sampled answer from the exact
  solution of the reference (``max |x - x*| / max |x*|``, float64);
- ``unconverged``: a solve that used all of ``maxiter`` reads 1;
- ``iters_short``: for a sampled solve, the iterations at which the
  reference solver (``reference/<solver>.py``, float64, with the
  reference preconditioner) first has its residual under ``rtol``,
  less the iterations the program's solve took: a solve stopped early
  reads above 0;
- ``precond_rel_err``: the widest gap of a sampled application of the
  preconditioner from the reference preconditioner's on the same
  ``r``, ``max |z - z_ref| / max |z_ref|``.
"""

from __future__ import annotations

from typing import List

import torch

from ..core import profile as _profile
from ..core import spec, system
from ..core.traffic import Checks, Mix as _Mix, Reservoir, Window, derive
from ..core.traffic import rel_err, sync, uniform, worst


class Mix(_Mix):
    def rhs(self, i: int) -> torch.Tensor:
        return uniform(self.n, self.mix["rhs"], derive(self.seed, "rhs", i),
                       self.dtype, self.device)

    def prepare(self, A, M=None) -> None:
        """The warm-up: one product and one short solve, through the
        same wrapped preconditioner as the window's."""
        self.recording = False
        self.solving = -1
        self.app_solve: List[int] = []
        self.pre_sample = Reservoir(int(self.mix.get("precond_sample", 0)),
                                    derive(self.seed, "precond"))
        self.Ms = None if M is None else system.wrap(
            M, lambda r: None, self._applied)
        b = self.rhs(-1)
        system.matvec(A, b)
        warm = dict(self.mix["solver"],
                    maxiter=int(self.mix["warmup_maxiter"]))
        x, _ = system.solve(A, b, warm, self.Ms)
        self.sample.prepare(x)
        self.pre_sample.prepare(b, x)
        sync(self.device)
        self.recording = True

    def release(self) -> None:
        super().release()
        self.Ms = None

    def _applied(self, r, z) -> None:
        if self.recording and self.pre_sample.k:
            self.pre_sample.offer(len(self.app_solve), r, z)
            self.app_solve.append(self.solving)

    def _one(self, w: Window, M) -> int:
        i = w.count
        self.solving = i
        x, it = system.solve(self.A, self.rhs(i), self.mix["solver"], M)
        w.iters.append(it)
        if it >= int(self.mix["solver"]["maxiter"]):
            w.unconverged.append(i)
        self.sample.offer(i, x)
        w.count += 1
        return it

    def step(self, w: Window) -> None:
        self._one(w, self.Ms)

    def profiled(self, w: Window) -> None:
        want = int(self.mix["profile"]["solves"])
        with _profile.Slice(self.device) as sl:
            for _ in range(want):
                w.slice_iters += self._one(w, self.Ms)
        w.trace = sl.trace
        if self.Ms is None or self.device.type != "cuda":
            return
        events: list = []

        def start(r):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append([e])

        def end(r, z):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[-1].append(e)

        timed = system.wrap(self.Ms, start, end)
        for _ in range(want):
            self._one(w, timed)
        sync(self.device)
        w.vcycle_s = [s.elapsed_time(e) * 1e-3 for s, e in events]

    def checks(self, ref, wanted, w: Window, control: bool = False) -> Checks:
        out: Checks = {}
        low = torch.bfloat16
        pre = self.mix.get("preconditioner")
        pre_ref = None
        if pre and ({"precond_rel_err", "iters_short"} & wanted):
            pre_ref = spec.part("reference", pre["name"]).Preconditioner(
                ref, self.config, pre)
        solver = self.mix["solver"]
        if "max_rel_err" in wanted:
            gaps = {}
            for i, (x,) in self.sample.items():
                b = self.rhs(i)
                want = ref.solve(b)
                gaps[i] = rel_err(ref.solve(b, low) if control else x, want)
            out["max_rel_err"] = gaps
        if "precond_rel_err" in wanted:
            applied = self.pre_sample.items()
            wants = [pre_ref.apply(r) for _, (r, _z) in applied]
            if control:
                # A hierarchy of its own for the control, built once the
                # float64 one is freed: at full size both do not fit.
                pre_ref = None
                torch.cuda.empty_cache()
                pre_ref = spec.part("reference", pre["name"]).Preconditioner(
                    ref, self.config, pre)
            gaps = {}
            for (j, (r, z)), want in zip(applied, wants):
                got = pre_ref.apply(r, low) if control else z
                i = self.app_solve[j]
                gaps[i] = worst([gaps.get(i, 0.0), rel_err(got, want)])
            out["precond_rel_err"] = gaps
        if control:
            return out
        if "unconverged" in wanted:
            out["unconverged"] = {
                i: float(i in w.unconverged) for i in range(w.count)}
        if "iters_short" in wanted:
            cross = spec.part("reference", solver["name"]).crossing
            out["iters_short"] = {
                i: float(cross(ref.apply, pre_ref and pre_ref.apply,
                               self.rhs(i), float(solver["rtol"]),
                               int(solver["maxiter"])) - w.iters[i])
                for i, _ in self.sample.items()}
        return out
