"""Readings that a cell's limits are set from, on the card, in one process.

    python3 spbench/calibrate.py --workload <name> --seeds <n> [--first-seed S]
        [--control <c>] [--faults <f>] [--seconds <s>] [--out <file.json>]

Builds the cell once, then for each of ``--seeds`` seeds runs a short
window of the cell's own traffic (``--seconds``, long enough that the
window holds as many answers as a run samples), keeping its sampled
answers on the host.  Once the program's state is freed, as a run
frees it, it reads every number that the cell's limits name on each
seed's answers, exactly as a run does: the program's readings.  For the first ``--control`` seeds it also reads the
control: the reference computed in bfloat16, one rung below the
configuration's float32, put in the program's place on the same
sampled answers.  For the first ``--faults`` seeds of a solve cell it
reads a planted fault: every solve run to ten times the mix's ``rtol``
(a solve stopped early).  The readings of the true residual
``|b - A x| / |b|`` (float64, the reference's ``A``) of the program's
sampled answers and of the exact solution rounded to the
configuration's type are printed beside them.  A number's limit lies
between the program's largest reading and the least reading that
fails (``spbench/limits/<workload>.json``).  Prints one JSON line and
writes it to ``--out``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The reference's hierarchies, built one after another at full size,
# leave the caching allocator's blocks too split for the next one's
# largest product unless its segments can grow.  Set before torch loads.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import run  # noqa: E402,F401  (sets the build directories and sys.path)

import torch  # noqa: E402

from spbench.core import harness, spec, system  # noqa: E402
from spbench.core import traffic as _traffic  # noqa: E402


def residuals(mix, ref) -> dict:
    """The true residual of the sampled answers, and of the exact
    solution rounded to the value type: the least any answer in that
    type can read."""
    prog, floor = [], []
    for i, (x,) in mix.sample.items():
        b = mix.rhs(i).to(torch.float64)
        nb = float(torch.linalg.vector_norm(b))
        prog.append(float(torch.linalg.vector_norm(b - ref.apply(x))) / nb)
        exact = ref.solve(b).to(mix.dtype)
        floor.append(float(torch.linalg.vector_norm(b - ref.apply(exact)))
                     / nb)
    return {"program": max(prog), "exact_rounded": min(floor)}


def loose(solve):
    """The planted fault: the solver's ``rtol`` ten times the mix's."""
    def broken(A, b, solver, M=None):
        return solve(A, b, dict(solver, rtol=10 * float(solver["rtol"])), M)
    return broken


def park(m, device: torch.device) -> None:
    """Move the answers that ``m`` sampled to ``device``: to the host
    while the program's state is on the card, back for the comparison."""
    for r in vars(m).values():
        if isinstance(r, _traffic.Reservoir):
            r.bufs = [tuple(t.to(device) for t in b) for b in r.bufs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    A, M, mix, setup = harness.build(cell, dev, seeds[0], False, T_START)
    n, dtype = mix.n, mix.dtype
    kind = spec.part("kinds", cell.traffic["kind"])
    solving = cell.traffic["kind"] == "solve"
    readings = {"program": {}, "control": {}, "fault": {}}
    extra = {}

    def window(seed):
        m = kind.Mix(cell.traffic, cell.config, n, dev, dtype, seed)
        m.prepare(A, M)
        w = m.run(A, M, args.seconds, False)
        park(m, torch.device("cpu"))
        return seed, m, w

    windows = {"program": [window(seed) for seed in seeds], "fault": []}
    if solving:
        honest = system.solve
        system.solve = loose(honest)
        windows["fault"] = [window(seed) for seed in seeds[:args.faults]]
        system.solve = honest
    # As in a run, the program's state is freed before the reference
    # runs: the reference's own operators need the memory.
    mix.release()
    del A, M, mix
    gc.collect()
    torch.cuda.empty_cache()

    def record(seed, key, found):
        readings[key][seed] = {name: _traffic.worst(v.values())
                               for name, v in found.items()}
        print(f"seed {seed} {key}: {readings[key][seed]} "
              f"{extra.get(seed, '') if key == 'program' else ''}",
              file=sys.stderr, flush=True)

    def compare(m, w, control=False):
        # Each comparison starts from an empty cache: the blocks that the
        # last one left would split the reference's large allocations.
        gc.collect()
        torch.cuda.empty_cache()
        return harness.compare(cell, m, w, control)

    for key, runs in windows.items():
        for k, (seed, m, w) in enumerate(runs):
            park(m, dev)
            if key == "program" and solving:
                ref = spec.part("reference", cell.config["operator"]
                                ).operator(cell.config, seed, dev)
                extra[seed] = dict(residuals(m, ref), answers=w.count,
                                   iters=sorted(set(w.iters)))
            record(seed, key, compare(m, w))
            if key == "program" and k < args.control:
                record(seed, "control", compare(m, w, True))
            park(m, torch.device("cpu"))
    summary = {}
    for key, per in readings.items():
        names = {n for v in per.values() for n in v}
        op = min if key != "program" else max
        summary[key] = {n: op(v[n] for v in per.values() if n in v)
                        for n in sorted(names)}
    out = {"workload": args.workload, "card": run.power_limit(),
           "setup": setup, "readings": readings, "residuals": extra,
           "program_max": summary["program"],
           "control_min": summary["control"], "fault_min": summary["fault"]}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
