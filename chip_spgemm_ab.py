#!/usr/bin/env python3
# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Time the banded SpGEMM kernel of one or more checkouts on one CUDA
card, in turns, at ``chip_smoke.py``'s phase-7 shape.

    python3 chip_spgemm_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (for a parent
commit, one unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  The roots run in the order given and then in the
reverse order, each in a process of its own (the package has one name
in all of them): its ``dia_spgemm`` built from its own sources, then
held to its plain version and timed on a 5-diagonal band of 2^24
columns squared into 9 output diagonals, in f32 and bf16, with B a
distinct band and with B = A.  Times: CUDA events around 10 calls in a
row, median of 25 such samples after 3 warmups.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
line per process.  Exits non-zero without a CUDA device or on any
mismatch.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

N = 1 << 24
OFFS = (-2, -1, 0, 1, 2)


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"


def _timing():
    """This checkout's ``bench_timing`` module, loaded from its file so
    that the package the child times stays the one under ROOT."""
    path = (Path(__file__).resolve().parent / "legate_sparse_tpu_torch"
            / "bench_timing.py")
    spec = importlib.util.spec_from_file_location("_ab_bench_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str) -> dict:
    """Time ``root``'s kernel: one JSON object."""
    import time

    import torch

    time_ms = _timing().time_ms
    sys.path.insert(0, root)
    from legate_sparse_tpu_torch.ops import _build, dia_kernel

    t0 = time.perf_counter()
    _build.build_all(["dia_spgemm"])
    result = {"root": root, "build_s": time.perf_counter() - t0,
              "ptxas": [ln.strip() for ln in _build.LOGS.get(
                  "dia_spgemm", "").splitlines()
                        if "registers" in ln or "spill" in ln]}
    dev = torch.device("cuda")
    args = (OFFS, OFFS, tuple(range(-4, 5)), (N, N), (N, N))
    gen = torch.Generator(device=dev).manual_seed(0)

    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn((5, N), generator=gen, device=dev).to(dtype)
        b = torch.randn((5, N), generator=gen, device=dev).to(dtype)
        C = dia_kernel.dia_spgemm(a, b, *args)
        if not torch.equal(C, dia_kernel.dia_spgemm_plain(a, b, *args)):
            raise RuntimeError(f"{dtype}: not bitwise equal")
        result[f"{str(dtype)[6:]}_ms"] = {
            "b_distinct": time_ms(lambda: dia_kernel.dia_spgemm(a, b, *args)),
            "b_is_a": time_ms(lambda: dia_kernel.dia_spgemm(a, a, *args))}
        del a, b, C
    return result


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_spgemm_ab: no CUDA device is available", file=sys.stderr)
        return 2
    roots = [str(Path(r).resolve()) for r in sys.argv[1:]]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    print(_smi(), flush=True)
    for root in roots + roots[::-1]:
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root],
            env=env, text=True, capture_output=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip(), flush=True)
    print(_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
