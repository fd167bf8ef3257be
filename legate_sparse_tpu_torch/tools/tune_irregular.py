# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Irregular-path shoot-out on the card: the port of
``tools/tune_irregular.py``, a thin CLI over the autotuner.

Races the autotune candidate registry (``autotune/registry.py``) on the
irregular configs the reference's general path serves, records each
winning verdict in ``autotune.get_store()``, and times the BSR kernel
(``ops/bsr.py``, ``csrc/bsr_spmv.cu``; not a registry candidate: the
dispatch gives it priority) across densities and a clustered config
(dense 8x8 sub-blocks at random block positions, the FEM pattern) where
the population of a present block, not the global density, sets the
rate.

The configs are the JAX tool's, in its order, drawn from one
``np.random.default_rng(0)`` (the seeded x of each config too):
uniform random at three densities, ``gallery.powerlaw`` (f32, as the
JAX tool's on its accelerator), the clustered pattern, and a
hyper-sparse 2^22-row matrix with 11 entries a row.  ``FULL`` holds the
JAX tool's sizes, ``SMOKE`` the same configs at a few thousand rows.

A config's candidates are timed by ``autotune.measure_candidates`` (1
warmup, 5 trials), the harness ``tune()`` and the bench use; the winner
is cross-checked by ``bench_timing.loop_ms_per_iter``.  Where
``ops/bsr.py::build_structure(..., max_expand=1e9)`` packs (at most
``MAX_BLOCKS`` blocks), ``BsrStructure.matvec`` is timed the same way,
beside ``bsr_bound_ms``: the bytes ``spmv_traffic_bytes(x,
path="bsr")`` prices over the H100's 3.35 TB/s (or its operations over
67 TFLOP/s, if larger).  A config over the block budget records no
``bsr_*`` field.  Times are milliseconds, unrounded; ``density`` and
``nnz_per_block`` are rounded as the JAX tool rounds them.  Nothing is
caught: a kernel that fails to build or launch ends the run.

Run on the card: ``python -m legate_sparse_tpu_torch.tools.tune_irregular``
(``--device cpu`` for the CPU, ``--smoke`` for the small sizes, ``--out
PATH`` to write the JSON line to a file too).  It prints one JSON line:
``platform``, ``platform_fp``, ``configs``, ``verdicts``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# The configs' sizes: uniform (rows, density) triples, the power-law
# rows, the clustered rows (8x8 blocks, 27 a block-row) and the
# hyper-sparse rows (11 entries a row).
FULL = {"uniform": ((1 << 14, 0.005), (1 << 14, 0.02), (1 << 13, 0.08)),
        "powerlaw_rows": 1 << 18, "clustered_rows": 1 << 15,
        "hyper_rows": 1 << 22}
SMOKE = {"uniform": ((1 << 11, 0.005), (1 << 11, 0.02), (1 << 10, 0.08)),
         "powerlaw_rows": 1 << 11, "clustered_rows": 1 << 10,
         "hyper_rows": 1 << 11}
POWERLAW_NNZ_PER_ROW, POWERLAW_SEED = 8, 11
CLUSTER, CLUSTERS_PER_ROW = 8, 27
HYPER_W = 11


def configs(size: dict, rng):
    """``(label, spec)`` of each config in the JAX tool's order; a
    ``("coo", r, c, n)`` spec's coordinates are drawn from ``rng`` when
    the generator reaches it, so a caller that draws its x from ``rng``
    between configs draws what the JAX tool draws.  ``("powerlaw", n)``
    is ``gallery.powerlaw(n, nnz_per_row=8, rng=11)``."""
    for n, d in size["uniform"]:
        nnz = int(n * n * d)
        r = rng.integers(0, n, nnz)
        c = rng.integers(0, n, nnz)
        yield f"uniform_{n}_{d}", ("coo", r, c, n)
    n = size["powerlaw_rows"]
    yield (f"powerlaw_2e{n.bit_length() - 1}_w{POWERLAW_NNZ_PER_ROW}",
           ("powerlaw", n))
    # Clustered: dense 8x8 sub-blocks at random positions, 27 a
    # block-row like a 3-D stencil (the JAX tool's arithmetic).
    n = size["clustered_rows"]
    bs, per_row = CLUSTER, CLUSTERS_PER_ROW
    nb = (n // bs) * per_row
    br = np.repeat(np.arange(n // bs), per_row)
    bc = rng.integers(0, n // bs, nb)
    rr = (br[:, None] * bs + np.arange(bs)[None, :]).ravel()
    r = np.repeat(rr, bs)
    c = ((bc[:, None] * bs + np.arange(bs)[None, :])[:, None, :]
         + np.zeros((1, bs, 1), np.int64)).ravel()
    yield f"clustered_fem_{bs}x{bs}", ("coo", r, c, n)
    # Hyper-sparse tail: BSR over budget at full size, the gather
    # candidates the ceiling.
    n = size["hyper_rows"]
    r = np.repeat(np.arange(n), HYPER_W)
    c = rng.integers(0, n, n * HYPER_W)
    yield (f"hyper_sparse_2e{n.bit_length() - 1}_W{HYPER_W}",
           ("coo", r, c, n))


def build(spec, device):
    """The port's ``csr_array`` of a config spec on ``device``: COO
    sorted by (row, col) on the host, f32 ones (the JAX tool's
    ``from_coo``), or the power-law matrix in f32."""
    import torch

    from .. import gallery
    from ..csr import csr_array

    if spec[0] == "powerlaw":
        return gallery.powerlaw(spec[1], nnz_per_row=POWERLAW_NNZ_PER_ROW,
                                rng=POWERLAW_SEED, dtype=np.float32,
                                device=device)
    _, r, c, n = spec
    order = np.lexsort((c, r))
    vals = torch.ones(r.shape[0], dtype=torch.float32)
    return csr_array((vals, (r[order], c[order])), shape=(n, n),
                     device=device)


def measure(A, x, label: str, build_s: float, keep=None) -> dict:
    """One config's record (the JAX tool's ``measure``): the candidate
    race and its verdict, the winner's chained-loop time, and the BSR
    kernel's time where the structure packs.  ``keep``, a list, gets
    ``(label, structure)`` of a config that packs."""
    from .. import autotune
    from ..bench_timing import (F32_OPS_PER_S, HBM_BYTES_PER_S,
                                loop_ms_per_iter)
    from ..ops import bsr as bsr_ops

    rows, cols = A.shape
    nnz = A.nnz
    cfg = {"label": label, "rows": rows, "nnz": nnz,
           "density": round(nnz / (rows * cols), 6),
           "fingerprint": A._get_fingerprint().klass, "build_s": build_s}
    useful_bytes = nnz * 8  # value + column index, CSR-equivalent terms

    timings = autotune.measure_candidates(A, x, warmup=1, trials=5)
    for lbl, ms in timings.items():
        k = lbl.replace("-", "_")
        cfg[k + "_ms"] = ms
        cfg[k + "_gbs"] = useful_bytes / ms / 1e6
    winner = min(timings, key=timings.get)
    cfg["verdict"] = winner
    key = autotune.key_for(A, "spmv")
    autotune.get_store().record(key, winner, timings_ms=timings, trials=5)
    cfg["verdict_key"] = key.key_id
    run = autotune.CANDIDATES[winner].run
    cfg["winner_loop_ms"] = loop_ms_per_iter(lambda v: run(A, v, "spmv"),
                                             x, k_lo=2, k_hi=6)

    st = bsr_ops.build_structure(A.data, A.indices, A.indptr,
                                 A._get_row_ids(), A.shape, max_expand=1e9)
    if st is not None:
        cfg["nblocks"] = st.nblocks
        cfg["nnz_per_block"] = round(nnz / st.nblocks, 1)
        before = bsr_ops.bsr_spmv.launches
        ms = loop_ms_per_iter(lambda v: st.matvec(v), x, k_lo=3, k_hi=13)
        cfg["bsr_launches"] = bsr_ops.bsr_spmv.launches - before
        cfg["bsr_ms"] = ms
        cfg["bsr_gbs"] = useful_bytes / ms / 1e6
        cfg["bsr_stream_gbs"] = (st.nblocks * 128 * 128 * 4) / ms / 1e6
        cfg["bsr_bytes"] = A.bsr_traffic_bytes(st, x)
        cfg["bsr_bound_ms"] = max(cfg["bsr_bytes"] / HBM_BYTES_PER_S,
                                  2 * nnz / F32_OPS_PER_S) * 1e3
        if keep is not None:
            keep.append((label, st))
    return cfg


def run(size: dict, device, keep=None) -> dict:
    """The shoot-out at ``size`` (``FULL`` or ``SMOKE``) on ``device``
    with tuning on (restored after): ``{"platform", "platform_fp",
    "configs", "verdicts"}``; ``verdicts`` counts the distinct verdict
    keys this run recorded."""
    import torch

    from .. import autotune
    from ..settings import settings
    from ..types import to_numpy_dtype

    dev = torch.device(device)
    was_on = settings.autotune
    settings.autotune = True
    try:
        out = {"platform": dev.type,
               "platform_fp": autotune.platform_fingerprint(),
               "configs": []}
        rng = np.random.default_rng(0)
        keys = set()
        for label, spec in configs(size, rng):
            t0 = time.perf_counter()
            A = build(spec, dev)
            A.sum_duplicates()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            build_s = time.perf_counter() - t0
            x = torch.as_tensor(rng.standard_normal(A.shape[1]).astype(
                to_numpy_dtype(A.dtype)), device=dev)
            cfg = measure(A, x, label, build_s, keep)
            keys.add(cfg["verdict_key"])
            out["configs"].append(cfg)
            del A, x
        out["verdicts"] = len(keys)
    finally:
        settings.autotune = was_on
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Irregular-path shoot-out: autotune candidates and "
                    "the BSR kernel.")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="the same configs at a few thousand rows")
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    import torch

    from .. import runtime

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tune_irregular: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    runtime.set_device(dev)
    out = run(SMOKE if args.smoke else FULL, dev)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
