#!/usr/bin/env python3
# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: the five CUDA kernels from ``legate_sparse_tpu_torch/csrc``
   (one nvcc each, started together), their seconds and ptxas'
   registers and spills;
3. kernels against their plain PyTorch versions on the card: DIA SpMV
   (f32 exact band, f32 holey band with inf/NaN in x at holes and out
   of the band's reach, rectangular, offsets past ±128 and ±2^17,
   bf16), DIA SpMM (f32 exact band, f32 holey band with inf/NaN in X at
   holes, rectangular, k in {1, 7, 16, 1024}, bf16), and where the two
   DIA kernels switch variants, each with inf/NaN in x or X at columns
   that only holes reach: an odd row count, an x/X one element into a
   larger buffer, nd past the unrolled counts (9, 33), k not divisible
   by 4 (5, 17) or 8 (bf16, 12), bf16 with an odd row count, and the
   strided ``A @ X[:, 0]`` and ``A @ X[:, :1]`` through
   ``csr_array.dot`` (each DIA case bit for bit, with the variant it
   took); BSR SpMV and SpMM
   (f32 and bf16: a block-clustered matrix with k in {1, 5, 16, 512},
   and a matrix with a block-row of 40 present blocks, an empty
   block-row and a row of 6,000 entries, with inf and NaN in x and in
   one column of X at stored and unstored columns of present blocks,
   k in {5, 16, 40}, int32 and int64 column indices; the NaN/inf
   pattern equal element for element) and DIA SpGEMM (f32 on offsets
   ±{0, 1, 2}, offsets past ±2^17, a rectangular A·B, bf16; and, in
   f32 and bf16, where it switches between its tiled and general
   variants or meets a tile's edge: n below one tile and not a
   multiple of it, an output diagonal with no pair (its row all 0), A's
   reach at the tiled variant's shared-memory limit and one column
   past, 9 and 33 diagonals, one tensor as A and B, and two calls with
   no synchronisation between; each bit for bit, with the variant it
   took);
4. main path at full size: the 4096x4096-grid 5-point Poisson operator
   (16,777,216 unknowns, f32) built by ``diags(...)`` in CSR on the
   card; ``A @ x`` through ``"dia-kernel"`` against scipy's f64 SpMV,
   the explicit update ``v - 0.25*(A@v) + b``, 500 CG iterations
   (one DIA launch per iteration plus one for ``r0``), and the pde
   app solved to tolerance on a 512x512 grid;
5. SpMM on the same operator: ``A @ X`` for X (2^24, 16) through
   ``"dia-kernel"``, three columns against scipy f64;
6. irregular SpMV and SpMM at 2^20 rows, 8 present 128x128 blocks per
   block-row (65,536 blocks), 16 nonzeros per row, f32, from seed 0:
   the BSR structure's build seconds on the card and the device bytes
   it adds (under 1 MiB), then ``A @ x`` and ``A @ X`` (X (2^20, 16))
   through ``"bsr"`` against scipy f64;
7. SpGEMM: ``A @ A`` for the SpGEMM microbenchmark's banded matrix
   (``examples/common.py::banded_matrix``, 5 ones per row) at 2^24
   rows, f32, through ``"dia-kernel"``, a seeded sample of 4096 rows
   against scipy's f64 product (exact: the values are small integers);
   and ``P @ P`` for the 1024x1024-grid Poisson operator, whose band
   has holes, through ``"esc"``, all of it against scipy;
8. GMG: ``apps/gmg.py`` on the 4096x4096 Poisson grid, f32, linear
   restriction, 8 levels (the coarsest grid used is 32x32): the
   hierarchy's build seconds, every SpGEMM's route and every
   operator's SpMV path, GMG-CG to rtol 1e-5 (iterations, ms/iter, the
   true relative residual in f64 beside its f32 floor) and plain CG on
   the same system and tolerance, which must take more iterations.
   The launch counts are those of the GMG-CG solve alone, and must
   equal what its operators' SpMV paths call for.  Every level's
   Galerkin product is held to scipy's f64 ``R @ A @ P`` on a seeded
   sample of rows, and x to the exact solution of the f64 system (by
   the discrete sine transform on the host);
9. for each kernel at the shapes of phases 4-7: its time (CUDA events
   around 10 calls in a row, median of 25 such samples after warmup),
   the least time the card could take (bytes over 3.35 TB/s,
   operations over 67 TFLOP/s f32; for the BSR kernels the bytes of the
   stored nonzeros, not of dense blocks), the plain version's time and
   one PyTorch library call's time
   (``torch.sparse_csr_tensor @ x``, ``@ X`` or ``@`` another
   ``sparse_csr_tensor``: a yardstick the port never calls).  The
   SpGEMM kernel is timed with B a distinct copy of A's band; beside it
   its device time per call under ``torch.profiler`` over the same 10
   calls (the trace must hold no copy and fewer synchronisations than
   calls), and the aliased ``A @ A`` whole and split into the kernel and
   ``band_to_csr``.

Launch counts come from the kernel wrappers: each is set to 0 just
before a main-path phase drives its path and read just after.  Any
failed check raises, so the script exits non-zero; it exits non-zero
without printing a result when there is no CUDA device.  The last three
lines are the ``kernels`` JSON object, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import subprocess
import sys
import time
import warnings

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, f32 outside tensor cores
REPS = 25
INNER = 10                     # calls per timed sample


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    import numpy as np
    import scipy.sparse as sp
    from scipy import fft

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import linalg
    from legate_sparse_tpu_torch.apps import gmg as gmg_app
    from legate_sparse_tpu_torch.apps import pde
    from legate_sparse_tpu_torch.ops import _build
    from legate_sparse_tpu_torch.ops import bsr as bsr_ops
    from legate_sparse_tpu_torch.ops import dia_kernel
    from legate_sparse_tpu_torch.ops import dia_ops
    from legate_sparse_tpu_torch.ops import spmv as spmv_ops

    warnings.filterwarnings(
        "ignore", message="Sparse (CSR tensor support|invariant checks)")
    # Plain versions run float32 products in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log({"phase": "device", "kind": kind,
         "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
         "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in _build.LOGS.items()}
    log({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    def sync():
        torch.cuda.synchronize(dev)

    def time_ms(fn, reps: int = REPS) -> float:
        """Median over ``reps`` samples of the time per call of ``INNER``
        calls in a row: the card runs them back to back, so the host's
        cost of each launch stays out of a kernel's time."""
        for _ in range(3):
            fn()
        sync()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(INNER):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / INNER)
        return float(np.median(times))

    def profile_calls(fn, name: str) -> dict:
        """``INNER`` calls of ``fn`` in a row under ``torch.profiler``:
        the device time per call of the kernels whose name holds
        ``name`` (None when the trace holds no device time), and the
        count of every copy and synchronisation in the trace."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(INNER):
                fn()
            end = torch.cuda.Event()
            end.record()
            end.synchronize()
        rows = prof.key_averages()

        def device_us(e):
            return float(getattr(e, "device_time_total",
                                 getattr(e, "cuda_time_total", 0.0)))

        kern = [e for e in rows if name in e.key and device_us(e) > 0]
        return {"kernel_device_ms_per_call": (
                    sum(device_us(e) for e in kern) / 1e3 / INNER
                    if kern else None),
                "kernels": {e.key: e.count for e in kern},
                "copies": {e.key: e.count for e in rows
                           if "memcpy" in e.key.lower()},
                "synchronizations": {e.key: e.count for e in rows
                                     if "synchronize" in e.key.lower()}}

    def max_abs(a, b) -> float:
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0

    def close(y, ref, rtol: float, what: str) -> float:
        sync()
        check(bool(torch.isfinite(y).all()) == bool(torch.isfinite(ref).all()),
              f"{what}: finiteness differs")
        err = max_abs(y, ref)
        scale = float(ref.float().abs().max()) if ref.numel() else 0.0
        check(err <= rtol * max(scale, 1.0), f"{what}: max |Δ| {err} > "
              f"{rtol} * {scale}")
        return err

    counters = {"dia_spmv": dia_kernel.dia_spmv, "bsr_spmv": bsr_ops.bsr_spmv,
                "dia_spmm": dia_kernel.dia_spmm, "bsr_spmm": bsr_ops.bsr_spmm,
                "dia_spgemm": dia_kernel.dia_spgemm}

    def reset_counts() -> None:
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in counters.items()}

    def bound(nbytes: float, nops: float) -> dict:
        """``bound_ms`` and ``bound_by`` of a kernel moving ``nbytes``
        and doing ``nops`` f32 operations."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
        return {"bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def dia_case(name, A, x, bitwise):
        packed = A._get_dia_pack()
        check(packed is not None, f"{name}: the DIA kernel must take it")
        y = dia_kernel.dia_spmv(packed, x)
        yp = dia_kernel.dia_spmv_plain(packed.rdata, packed.rmask, x,
                                       packed.offsets, packed.shape)
        err = close(y, yp, 1e-6, name)
        if bitwise:
            check(torch.equal(y, yp), f"{name}: not bitwise equal")
        return {"case": name, "rows": packed.shape[0],
                "cols": packed.shape[1], "offsets": list(packed.offsets),
                "dtype": str(x.dtype), "masked": packed.rmask is not None,
                "max_abs_err": err, "bitwise": bool(torch.equal(y, yp))}

    rng = np.random.default_rng(0)

    def band(n, m, offsets, dtype):
        diagonals = [rng.standard_normal(
            min(n + min(o, 0), m - max(o, 0))).astype(np.float32)
            for o in offsets]
        return sparse.diags(diagonals, offsets, shape=(n, m), format="csr",
                            dtype=dtype)

    def randx(n, dtype=torch.float32):
        return torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)).to(dev, dtype)

    def randX(n, k, dtype=torch.float32):
        return torch.from_numpy(
            rng.standard_normal((n, k)).astype(np.float32)).to(dev, dtype)

    # ---- 3. kernels against their plain versions ---------------------------
    cases = []
    n = 1 << 20
    cases.append(dia_case("f32-exact", band(n, n, [-2, -1, 0, 1, 2],
                                            torch.float32), randx(n), True))
    # Holey band whose columns in S are stored only at holes, and x
    # columns past the band's reach: inf/NaN there must not reach y.
    m = n + 64
    main_d = rng.standard_normal(n).astype(np.float32)
    off2 = rng.standard_normal(n).astype(np.float32)
    S = np.arange(10, n, 1000)
    main_d[S] = 0.0
    off2[S - 2] = 0.0
    H = sparse.diags([main_d, off2], [0, 2], shape=(n, m), format="csr",
                     dtype=torch.float32)
    check(H._get_dia() is not None and H._get_dia()[2] is not None,
          "holey case must carry a hole mask")
    xh = randx(m)
    xh[torch.as_tensor(S[::2], device=dev)] = float("inf")
    xh[torch.as_tensor(S[1::2], device=dev)] = float("nan")
    xh[n + 2:] = float("nan")
    case = dia_case("f32-holey-nonfinite-x", H, xh, True)
    yh = H @ xh
    check(bool(torch.isfinite(yh).all()), "holey case: y must stay finite")
    cases.append(case)
    cases.append(dia_case("f32-rect-tall", band(n + 300, n, [-7, 0, 3],
                                                torch.float32),
                          randx(n), True))
    n2 = 1 << 19
    far = (1 << 17) + 3
    cases.append(dia_case("f32-offsets-past-2^17",
                          band(n2, n2, [-far, -129, 0, 129, far],
                               torch.float32), randx(n2), True))
    cases.append(dia_case("bf16", band(n, n, [-2, -1, 0, 1, 2],
                                       torch.bfloat16),
                          randx(n, torch.bfloat16), True))

    def block_clustered(rows, blocks_per_row, per_block):
        """Canonical CSR arrays: per block-row, ``blocks_per_row``
        distinct block-columns; per row, ``per_block`` distinct columns
        in each of them."""
        nbr = rows // 128
        bcols = np.stack([np.sort(rng.choice(nbr, blocks_per_row,
                                             replace=False))
                          for _ in range(nbr)])              # (nbr, k)
        row_bcols = np.repeat(bcols, 128, axis=0)            # (rows, k)
        picks = [rng.integers(0, 128, (rows, blocks_per_row))]
        for _ in range(per_block - 1):
            picks.append((picks[-1] + 1 + rng.integers(
                0, 128 // per_block, (rows, blocks_per_row))) % 128)
        cols = (row_bcols[:, :, None] * 128
                + np.stack(picks, axis=2)).reshape(rows, -1)
        cols = np.sort(cols, axis=1)
        check(bool((np.diff(cols, axis=1) > 0).all()), "columns distinct")
        nnz = cols.size
        indptr = np.arange(rows + 1, dtype=np.int64) * cols.shape[1]
        data = rng.standard_normal(nnz).astype(np.float32)
        return data, cols.reshape(-1).astype(np.int32), indptr

    def same_nonfinite(y, ref, rtol: float, what: str) -> float:
        """The NaN/inf pattern equal element for element, the finite
        values within ``rtol`` of the largest; the max |Δ| over them."""
        sync()
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            check(torch.equal(test(y), test(ref)),
                  f"{what}: {test.__name__} pattern differs")
        fin = torch.isfinite(ref)
        err = max_abs(y[fin], ref[fin])
        scale = float(ref[fin].float().abs().max()) if fin.any() else 0.0
        check(err <= rtol * max(scale, 1.0), f"{what}: max |Δ| {err} > "
              f"{rtol} * {scale}")
        return err

    def bsr_edge_case():
        """Canonical scipy CSR, 4096 x 8192: block-row 0 holds 40 present
        blocks (more than the SpMV kernel stages at once), block-row 1
        is empty, row 300 holds 6,000 entries, the other block-rows 2
        blocks of 2 entries per row.  And an x with inf at a column that
        row 0 stores (a*inf there, 0*inf = NaN in the rows of block-row
        0 that do not store it), NaN at a column of a present block of
        block-row 5 that none of its rows stores, and inf in chunk 0,
        under block-row 1's zero block."""
        nr, nc = 4096, 8192
        r = [np.repeat(np.arange(128), 40)]
        c = [np.tile(rng.choice(64, 40, replace=False) * 128, 128)
             + rng.integers(0, 128, 128 * 40)]
        r.append(np.full(6000, 300))
        c.append(rng.choice(nc, 6000, replace=False))
        rest = np.arange(256, nr)
        rest = rest[rest != 300]
        bc = rng.integers(0, 64, (nr // 128, 2))
        r.append(np.repeat(rest, 4))
        c.append((bc[rest // 128][:, [0, 0, 1, 1]] * 128
                  + rng.integers(0, 128, (rest.shape[0], 4))).reshape(-1))
        r, c = np.concatenate(r), np.concatenate(c)
        S = sp.csr_array((rng.standard_normal(r.shape[0]).astype(np.float32),
                          (r, c)), shape=(nr, nc))
        S.sum_duplicates()
        x = rng.standard_normal(nc).astype(np.float32)
        x[S.indices[S.indptr[0]]] = np.inf
        br5 = S[640:768]
        chunk = int(br5.indices[0]) // 128
        stored = set(br5.indices.tolist())
        x[next(cc for cc in range(chunk * 128, chunk * 128 + 128)
               if cc not in stored)] = np.nan
        x[5] = np.inf
        return S, x

    def bsr_check(name, st, dtype, ks, x_np=None):
        """Both BSR kernels on structure ``st`` against their plain
        versions; ``x_np`` (a column of X for SpMM) may hold inf/NaN."""
        x = randx(st.nbc * 128, dtype)
        if x_np is not None:
            x[: x_np.shape[0]] = torch.from_numpy(x_np).to(dev, dtype)
        x2d = x.reshape(-1, 128)
        y = bsr_ops.bsr_spmv(st, x2d)
        yp = bsr_ops.bsr_spmv_plain(st, x2d)
        out = [{"case": name, "kernel": "bsr_spmv", "rows": st.rows,
                "blocks": st.nblocks, "nnz": int(st.data.shape[0]),
                "max_blocks_per_block_row":
                    int((st.bptr[1:] - st.bptr[:-1]).max()),
                "nonfinite_y": int((~torch.isfinite(yp)).sum()),
                "max_abs_err": same_nonfinite(y, yp, 1e-5, name)}]
        for k in ks:
            X = randX(st.nbc * 128, k, dtype)
            if x_np is not None:
                X[: x_np.shape[0], k // 2] = torch.from_numpy(x_np).to(
                    dev, dtype)
            Y = bsr_ops.bsr_spmm(st, X)
            Yp = bsr_ops.bsr_spmm_plain(st, X)
            out.append({"case": f"{name}-k{k}", "kernel": "bsr_spmm", "k": k,
                        "nonfinite_y": int((~torch.isfinite(Yp)).sum()),
                        "max_abs_err": same_nonfinite(Y, Yp, 1e-5,
                                                      f"{name}-k{k}")})
        return out

    bsr_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        d, i, p = block_clustered(1 << 16, 8, 2)
        B = sparse.csr_array((d, i, p), shape=(1 << 16, 1 << 16),
                             dtype=dtype)
        st = B._get_bsr()
        check(st is not None, f"BSR {dtype}: structure must build")
        bsr_cases += bsr_check(f"bsr-{dname}", st, dtype, (1, 5, 16, 512))
        S_edge, x_nf = bsr_edge_case()
        E = sparse.csr_array(S_edge, dtype=dtype, device=dev)
        st = E._get_bsr()
        check(st is not None, f"BSR edge {dtype}: structure must build")
        check(st.brow.tolist().count(1) == 1, "edge: block-row 1 is empty")
        edge = bsr_check(f"bsr-edge-nonfinite-{dname}", st, dtype,
                         (5, 16, 40), x_nf)
        check(all(c["nonfinite_y"] > 0 for c in edge),
              "edge: the inf/NaN in x must reach y")
        bsr_cases += edge
        bsr_cases += bsr_check(f"bsr-edge-int64-{dname}", bsr_ops.BsrStructure(
            st.data, st.indices.to(torch.int64), st.indptr, st.brow, st.bcol,
            st.bptr, st.nbr, st.nbc, st.rows, st.cols), dtype, (16,), x_nf)
        del B, E, st

    def dia_spmm_case(name, A, X):
        packed = A._get_dia_pack()
        check(packed is not None, f"{name}: the DIA kernel must take it")
        Y = dia_kernel.dia_spmm(packed, X)
        Yp = dia_kernel.dia_spmm_plain(packed.rdata, packed.rmask, X,
                                       packed.offsets, packed.shape)
        err = close(Y, Yp, 1e-6, name)
        check(torch.equal(Y, Yp), f"{name}: not bitwise equal")
        return {"case": name, "rows": packed.shape[0],
                "cols": packed.shape[1], "k": X.shape[1],
                "offsets": list(packed.offsets), "dtype": str(X.dtype),
                "masked": packed.rmask is not None, "max_abs_err": err,
                "bitwise": True}

    spmm_cases = []
    E = band(n, n, [-2, -1, 0, 1, 2], torch.float32)
    for k in (1, 7, 16):
        spmm_cases.append(dia_spmm_case(f"f32-exact-k{k}", E, randX(n, k)))
    spmm_cases.append(dia_spmm_case(
        "f32-exact-k1024", band(1 << 16, 1 << 16, [-2, -1, 0, 1, 2],
                                torch.float32), randX(1 << 16, 1024)))
    # The holey band of the SpMV case: X rows that only holes reach, and
    # rows past the band's reach, hold inf/NaN.
    Xh = randX(m, 7)
    Xh[torch.as_tensor(S[::2], device=dev)] = float("inf")
    Xh[torch.as_tensor(S[1::2], device=dev)] = float("nan")
    Xh[n + 2:] = float("nan")
    spmm_cases.append(dia_spmm_case("f32-holey-nonfinite-X-k7", H, Xh))
    Yh = H @ Xh
    check(H.spmm_path == "dia-kernel", f"holey SpMM took {H.spmm_path}")
    check(bool(torch.isfinite(Yh).all()), "holey SpMM: Y must stay finite")
    spmm_cases.append(dia_spmm_case(
        "f32-rect-tall-k7", band(n + 300, n, [-7, 0, 3], torch.float32),
        randX(n, 7)))
    spmm_cases.append(dia_spmm_case(
        "bf16-k16", band(n, n, [-2, -1, 0, 1, 2], torch.bfloat16),
        randX(n, 16, torch.bfloat16)))

    # Where the DIA kernels switch variants (16-byte or scalar; an
    # unrolled or a chunked diagonal loop), on packs with holes and dead
    # columns (every slot a hole), where x and X hold inf and NaN.
    def holey_pack(rows, cols, nd, dtype):
        offsets = tuple(2 * d - nd for d in range(nd))
        data = rng.standard_normal((nd, cols)).astype(np.float32)
        keep = rng.random((nd, cols)) > 0.2
        dead = np.arange(5, cols, 997)
        keep[:, dead] = False
        data[~keep] = 0.0
        packed = dia_kernel.pack_band(
            torch.from_numpy(data).to(dev, dtype), offsets, (rows, cols),
            torch.from_numpy(keep).to(dev))
        check(packed is not None, "variant case: the kernel must take it")
        return packed, torch.as_tensor(dead, device=dev)

    def offset_view(shape, dtype, offset):
        numel = int(np.prod(shape))
        buf = torch.from_numpy(rng.standard_normal(numel + offset).astype(
            np.float32)).to(dev, dtype)
        return buf[offset:].view(shape)

    def variant_case(name, rows, nd, dtype, k=None, offset=0):
        packed, dead = holey_pack(rows, rows, nd, dtype)
        x = offset_view((rows,) if k is None else (rows, k), dtype, offset)
        x[dead[::2]] = float("inf")
        x[dead[1::2]] = float("nan")
        if k is None:
            y = dia_kernel.dia_spmv(packed, x)
            yp = dia_kernel.dia_spmv_plain(packed.rdata, packed.rmask, x,
                                           packed.offsets, packed.shape)
            vec = dia_kernel.spmv_vector_ok(packed)
        else:
            y = dia_kernel.dia_spmm(packed, x)
            yp = dia_kernel.dia_spmm_plain(packed.rdata, packed.rmask, x,
                                           packed.offsets, packed.shape)
            vec = dia_kernel.spmm_vector_ok(packed, x)
        sync()
        check(bool(torch.isfinite(y).all()), f"{name}: y must stay finite")
        check(torch.equal(y, yp), f"{name}: not bitwise equal")
        return {"case": name, "kernel": "dia_spmv" if k is None
                else "dia_spmm", "rows": rows, "nd": nd, "k": k,
                "dtype": str(dtype), "x_offset_elems": offset,
                "variant": "16-byte" if vec else "scalar",
                "diag_loop": ("unrolled" if vec and nd <=
                              dia_kernel.UNROLLED_DIAGS else "chunked"),
                "bitwise": True}

    odd = n + 3
    variant_cases = [
        variant_case("spmv-f32-odd-rows", odd, 5, torch.float32),
        variant_case("spmv-f32-unaligned-x", n, 5, torch.float32, offset=1),
        variant_case("spmv-f32-nd9", n, 9, torch.float32),
        variant_case("spmv-f32-nd33", n, 33, torch.float32),
        variant_case("spmv-bf16-odd-rows", odd, 5, torch.bfloat16),
        variant_case("spmv-bf16-nd9-unaligned-x", n, 9, torch.bfloat16,
                     offset=1),
        variant_case("spmm-f32-k5", n, 5, torch.float32, k=5),
        variant_case("spmm-f32-k16-unaligned-X", n, 5, torch.float32, k=16,
                     offset=1),
        variant_case("spmm-f32-k16-nd9", n, 9, torch.float32, k=16),
        variant_case("spmm-f32-k17-nd33", 1 << 16, 33, torch.float32, k=17),
        variant_case("spmm-bf16-k12-odd-rows", odd, 5, torch.bfloat16,
                     k=12),
        variant_case("spmm-bf16-k16-nd9", n, 9, torch.bfloat16, k=16)]
    check([c["variant"] for c in variant_cases]
          == ["scalar", "16-byte", "16-byte", "16-byte", "scalar", "16-byte",
              "scalar", "scalar", "16-byte", "scalar", "scalar", "16-byte"],
          f"variants taken: {[c['variant'] for c in variant_cases]}")

    # A strided x through csr_array.dot: X[:, 0] and X[:, :1].
    St = band(n, n, [-2, -1, 0, 1, 2], torch.float32)
    Xs = randX(n, 3)
    ys = St @ Xs[:, 0]
    check(St.spmv_path == "dia-kernel", f"strided x took {St.spmv_path}")
    ys1 = St @ Xs[:, :1]
    check(St.spmv_path == "dia-kernel" and tuple(ys1.shape) == (n, 1),
          f"X[:, :1] took {St.spmv_path}, shape {tuple(ys1.shape)}")
    ps = St._get_dia_pack()
    yps = dia_kernel.dia_spmv_plain(ps.rdata, ps.rmask, Xs[:, 0].contiguous(),
                                    ps.offsets, ps.shape)
    sync()
    check(torch.equal(ys, yps) and torch.equal(ys1[:, 0], yps),
          "strided x: not bitwise equal to the plain version")
    variant_cases.append({"case": "csr-dot-strided-x", "kernel": "dia_spmv",
                          "rows": n, "calls": ["A @ X[:, 0]", "A @ X[:, :1]"],
                          "path": St.spmv_path, "bitwise": True})
    del St, Xs, ys, ys1, yps, ps

    def spgemm_offs_c(offs_a, offs_b):
        return tuple(sorted({oa + ob for oa in offs_a for ob in offs_b}))

    def spgemm_case(name, m_, k_, n_, offs_a, offs_b, dtype, aliased=False,
                    twice=False):
        """The SpGEMM kernel against its plain version, bit for bit, with
        the variant it took.  ``aliased``: one tensor as A and B;
        ``twice``: two calls with no synchronisation between."""
        a = randX(len(offs_a), k_, dtype)
        b = a if aliased else randX(len(offs_b), n_, dtype)
        offs_c = spgemm_offs_c(offs_a, offs_b)
        pairs = dia_kernel.spgemm_pairs(offs_a, offs_b, offs_c, (m_, k_),
                                        (k_, n_))
        tiled = dia_kernel.spgemm_tiled_ok(
            offs_a, offs_b, offs_c, sum(map(len, pairs)), (m_, k_),
            (k_, n_), dtype)
        C = dia_kernel.dia_spgemm(a, b, offs_a, offs_b, offs_c, (m_, k_),
                                  (k_, n_))
        C2 = (dia_kernel.dia_spgemm(a, b, offs_a, offs_b, offs_c, (m_, k_),
                                    (k_, n_)) if twice else C)
        Cp = dia_kernel.dia_spgemm_plain(a, b, offs_a, offs_b, offs_c,
                                         (m_, k_), (k_, n_))
        err = close(C, Cp, 1e-6, name)
        check(torch.equal(C, Cp) and torch.equal(C2, Cp),
              f"{name}: not bitwise equal")
        empty = [ci for ci, ps in enumerate(pairs) if not ps]
        check(not empty or not bool(C[empty].any()),
              f"{name}: an output diagonal with no pair is not 0")
        return {"case": name, "shape_a": [m_, k_], "shape_b": [k_, n_],
                "offs_a": list(offs_a) if len(offs_a) <= 9 else len(offs_a),
                "offs_b": list(offs_b) if len(offs_b) <= 9 else len(offs_b),
                "dtype": str(dtype), "variant": "tiled" if tiled
                else "general", "empty_diags": len(empty),
                "max_abs_err": err, "bitwise": True}

    pm2 = (-2, -1, 0, 1, 2)
    spgemm_cases = [
        spgemm_case("f32-pm012", n, n, n, pm2, pm2, torch.float32),
        spgemm_case("f32-offsets-past-2^17", n2, n2, n2, (-far, 0, 129),
                    (-129, 0, far), torch.float32),
        spgemm_case("f32-rect", n, n - 1000, n + 500, (-3, 0, 2),
                    (-1, 0, 4), torch.float32),
        spgemm_case("bf16-pm012", n, n, n, pm2, pm2, torch.bfloat16)]
    # Where the kernel switches between its tiled and general variants,
    # and its tiles' edges (1,024 columns a tile).
    nd9 = tuple(2 * d - 9 for d in range(9))
    nd33 = tuple(2 * d - 33 for d in range(33))
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        # offs_a = (-1, 0), offs_b = (0, span): 4 output diagonals, 4
        # pairs.
        span = dia_kernel.spgemm_max_span(2, 2, 4, 4, dtype)
        spgemm_cases += [
            spgemm_case(f"{dn}-n-below-tile", 700, 700, 700, pm2, pm2, dtype),
            spgemm_case(f"{dn}-n-not-tile-multiple", n, n + 1, n - 3,
                        (-3, 0, 2), (-1, 0, 4), dtype),
            spgemm_case(f"{dn}-rect-empty-diag", 1500, 1200, 1300,
                        (-1499, 0, 3), (-1199, 0, 2), dtype),
            spgemm_case(f"{dn}-reach-at-limit", span + 600, span + 600,
                        span + 600, (-1, 0), (0, span), dtype),
            spgemm_case(f"{dn}-reach-past-limit", span + 601, span + 601,
                        span + 601, (-1, 0), (0, span + 1), dtype),
            spgemm_case(f"{dn}-nd9", 1 << 18, 1 << 18, 1 << 18, nd9, nd9,
                        dtype),
            spgemm_case(f"{dn}-nd33", 1 << 16, 1 << 16, 1 << 16, nd33, nd33,
                        dtype),
            spgemm_case(f"{dn}-aliased", n, n, n, pm2, pm2, dtype,
                        aliased=True),
            spgemm_case(f"{dn}-twice-no-sync", n, n, n, pm2, pm2, dtype,
                        twice=True)]
    check([c["variant"] for c in spgemm_cases]
          == ["tiled", "general", "tiled", "tiled"]
          + ["tiled"] * 4 + ["general", "tiled", "general", "tiled", "tiled"]
          + ["tiled"] * 4 + ["general", "tiled", "tiled", "tiled", "tiled"],
          f"SpGEMM variants taken: {[c['variant'] for c in spgemm_cases]}")
    check(all(c["empty_diags"] > 0 for c in spgemm_cases
              if "empty-diag" in c["case"]),
          "rect-empty-diag must have an output diagonal with no pair")
    log({"phase": "kernels_vs_plain", "dia": cases, "bsr": bsr_cases,
         "dia_spmm": spmm_cases, "dia_variants": variant_cases,
         "dia_spgemm": spgemm_cases})
    del H, xh, yh, Xh, Yh, E
    torch.cuda.empty_cache()

    # ---- 4. main path: pde_4096 -------------------------------------------
    reset_counts()
    grid = 4096
    n = grid * grid
    main3 = np.full(n, 4.0, np.float32)
    p1 = np.full(n - 1, -1.0, np.float32)
    p1[np.arange(1, grid) * grid - 1] = 0.0
    pN = np.full(n - grid, -1.0, np.float32)
    offsets = [0, 1, -1, grid, -grid]
    t0 = time.perf_counter()
    A = sparse.diags([main3, p1, p1, pN, pN], offsets, shape=(n, n),
                     format="csr", dtype=torch.float32)
    x = randx(n)
    y = A @ x
    sync()
    build_path_s = time.perf_counter() - t0
    check(A.spmv_path == "dia-kernel", f"pde SpMV took {A.spmv_path}")
    A_sp = sp.diags([d.astype(np.float64) for d in (main3, p1, p1, pN, pN)],
                    offsets, shape=(n, n), format="csr")
    xn = x.double().cpu().numpy()
    y_ref = A_sp @ xn
    mag = abs(A_sp) @ np.abs(xn)
    spmv_err = float(np.max(np.abs(y.double().cpu().numpy() - y_ref)))
    check(bool(np.all(np.abs(y.double().cpu().numpy() - y_ref)
                      <= 2e-6 * mag + 1e-30)),
          f"pde SpMV vs scipy f64: max |Δ| {spmv_err}")
    del y_ref, mag, xn

    b = torch.full((n,), 1e-6, dtype=torch.float32, device=dev)
    v = torch.ones(n, dtype=torch.float32, device=dev)
    explicit_ms = time_ms(lambda: v - 0.25 * (A @ v) + b)

    before = dia_kernel.dia_spmv.launches
    rhs = torch.ones(n, dtype=torch.float32, device=dev)
    sync()
    t0 = time.perf_counter()
    xs, iters = linalg.cg(A, rhs, rtol=0.0, maxiter=500)
    sync()
    cg_s = time.perf_counter() - t0
    cg_launches = dia_kernel.dia_spmv.launches - before
    check(iters == 500, f"cg ran {iters} iterations, expected 500")
    check(cg_launches == iters + 1,
          f"cg launched the DIA kernel {cg_launches} times for {iters} "
          f"iterations")
    check(bool(torch.isfinite(xs).all()), "cg iterate must be finite")
    del xs, rhs

    sol = pde.solve(512, 512, tol=1e-5, dtype=torch.float32)
    check(sol["path"] == "dia-kernel", f"pde app took {sol['path']}")
    # f32 cannot hold this solution to a true residual of 1e-3: the
    # rounding of x alone leaves ``residual_floor`` (apps/pde.py).  The
    # residual is held to that floor and the iterate to the exact
    # solution.
    check(sol["rel_residual"] <= max(1e-3, 2.0 * sol["residual_floor"]),
          f"pde app true relative residual {sol['rel_residual']} (f32 "
          f"floor {sol['residual_floor']})")
    check(sol["rel_error_to_exact"] <= 1e-3,
          f"pde app relative error to the exact solution "
          f"{sol['rel_error_to_exact']}")
    dia_launches = dia_kernel.dia_spmv.launches
    check(dia_launches > 0, "the main path launched no DIA kernel")
    log({"phase": "main_path_pde", "grid": f"{grid}x{grid}", "rows": n,
         "nnz": A.nnz, "path": A.spmv_path, "build_and_first_spmv_s":
         build_path_s, "spmv_max_abs_err_vs_scipy_f64": spmv_err,
         "explicit_step_ms_per_iter": explicit_ms,
         "cg_iters": iters, "cg_ms_per_iter": cg_s * 1e3 / iters,
         "cg_dia_launches": cg_launches,
         "pde_app": {k: sol[k] for k in ("grid", "n", "iters",
                                         "rel_residual", "residual_floor",
                                         "rel_error_to_exact", "solve_s",
                                         "path")},
         "dia_launches": dia_launches})
    del sol

    # ---- 6a. DIA timings at the pde shape -----------------------------------
    packed = A._get_dia_pack()
    nd = len(packed.offsets)
    yk = dia_kernel.dia_spmv(packed, x)
    yp = dia_kernel.dia_spmv_plain(packed.rdata, packed.rmask, x,
                                   packed.offsets, packed.shape)
    dia_err = close(yk, yp, 1e-6, "pde dia kernel vs plain")
    A_lib = torch.sparse_csr_tensor(A.indptr, A.indices.to(torch.int64),
                                    A.data, size=A.shape,
                                    check_invariants=False)
    y_lib = A_lib @ x
    close(y_lib, yp, 1e-5, "library csr SpMV vs plain")
    dia_bytes = nd * n * (4 + 1) + 4 * n + 4 * n
    dia_row = {
        "name": "dia_spmv", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "legate_sparse_tpu/ops/pallas_dia.py:312",
        "launches": dia_launches, "max_abs_err": dia_err,
        "ms": time_ms(lambda: dia_kernel.dia_spmv(packed, x)),
        "plain_ms": time_ms(lambda: dia_kernel.dia_spmv_plain(
            packed.rdata, packed.rmask, x, packed.offsets, packed.shape)),
        **bound(dia_bytes, 2 * nd * n),
        "library_ms": time_ms(lambda: A_lib @ x),
        "shape": {"rows": n, "diags": nd, "masked": True, "dtype": "float32",
                  "bytes": dia_bytes,
                  "variant": ("16-byte" if dia_kernel.spmv_vector_ok(packed)
                              else "scalar")},
    }
    log({"phase": "timing_dia", **dia_row})
    del yk, yp, y_lib, b, v

    # ---- 5. SpMM on the pde operator ---------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    kX = 16
    X = torch.randn((n, kX), generator=gen, device=dev)
    reset_counts()
    Y = A @ X
    sync()
    spmm_counts = read_counts()
    check(A.spmm_path == "dia-kernel", f"pde SpMM took {A.spmm_path}")
    check(spmm_counts["dia_spmm"] > 0, "pde SpMM launched no DIA SpMM kernel")
    X3 = X[:, :3].double().cpu().numpy()
    diff = np.abs(Y[:, :3].double().cpu().numpy() - A_sp @ X3)
    spmm_err = float(diff.max())
    check(bool(np.all(diff <= 2e-6 * (abs(A_sp) @ np.abs(X3)) + 1e-30)),
          f"pde SpMM vs scipy f64: max |Δ| {spmm_err}")
    del A_sp, X3, diff
    log({"phase": "main_path_spmm_pde", "rows": n, "k": kX,
         "path": A.spmm_path, "spmm_max_abs_err_vs_scipy_f64": spmm_err,
         "launches": spmm_counts})
    Yk = dia_kernel.dia_spmm(packed, X)
    Yp = dia_kernel.dia_spmm_plain(packed.rdata, packed.rmask, X,
                                   packed.offsets, packed.shape)
    spmm_kernel_err = close(Yk, Yp, 1e-6, "pde dia SpMM kernel vs plain")
    check(torch.equal(Yk, Yp), "pde dia SpMM kernel: not bitwise equal")
    close(A_lib @ X, Yp, 1e-5, "library csr SpMM vs plain")
    del Yk, Yp
    nb_, nops_ = nd * n * (4 + 1) + 2 * 4 * n * kX, 2 * nd * n * kX
    dia_spmm_row = {
        "name": "dia_spmm", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/dia_spmm.cu",
        "replaces": "legate_sparse_tpu/ops/pallas_dia.py:417",
        "launches": spmm_counts["dia_spmm"],
        "max_abs_err": spmm_kernel_err,
        "ms": time_ms(lambda: dia_kernel.dia_spmm(packed, X)),
        "plain_ms": time_ms(lambda: dia_kernel.dia_spmm_plain(
            packed.rdata, packed.rmask, X, packed.offsets, packed.shape)),
        **bound(nb_, nops_),
        "library_ms": time_ms(lambda: A_lib @ X),
        "shape": {"rows": n, "diags": nd, "k": kX, "masked": True,
                  "dtype": "float32", "bytes": nb_,
                  "variant": ("16-byte" if dia_kernel.spmm_vector_ok(packed, X)
                              else "scalar")},
    }
    log({"phase": "timing_dia_spmm", **dia_spmm_row})
    del A, A_lib, packed, x, y, X, Y
    torch.cuda.empty_cache()

    # ---- 6. irregular SpMV and SpMM through BSR -----------------------------
    rows = 1 << 20
    d, i, p = block_clustered(rows, 8, 2)
    R = sparse.csr_array((d, i, p), shape=(rows, rows))
    x = randx(rows)
    # The structure is built on the card from R's own tensors, after the
    # band test that runs first on every matrix (and caches the row ids).
    check(R._get_dia() is None, "the irregular matrix must not be banded")
    sync()
    t0 = time.perf_counter()
    st = R._get_bsr()
    sync()
    pack_s = time.perf_counter() - t0
    check(st is not None, "irregular BSR structure must build")
    check(st.extra_bytes < 1 << 20, f"BSR structure adds {st.extra_bytes} B")
    reset_counts()
    t0 = time.perf_counter()
    y = R @ x
    sync()
    bsr_first_s = time.perf_counter() - t0
    bsr_launches = bsr_ops.bsr_spmv.launches
    check(R.spmv_path == "bsr", f"irregular SpMV took {R.spmv_path}")
    check(bsr_launches > 0, "the irregular path launched no BSR kernel")
    R_sp = sp.csr_array((d.astype(np.float64), i, p), shape=(rows, rows))
    xn = x.double().cpu().numpy()
    diff = np.abs(y.double().cpu().numpy() - R_sp @ xn)
    bsr_spmv_err = float(diff.max())
    check(bool(np.all(diff <= 1e-5 * (abs(R_sp) @ np.abs(xn)) + 1e-30)),
          f"irregular SpMV vs scipy f64: max |Δ| {bsr_spmv_err}")
    del xn, diff
    log({"phase": "main_path_irregular", "rows": rows, "nnz": R.nnz,
         "blocks": st.nblocks, "path": R.spmv_path, "pack_s": pack_s,
         "structure_extra_bytes": st.extra_bytes,
         "first_spmv_s": bsr_first_s,
         "spmv_max_abs_err_vs_scipy_f64": bsr_spmv_err,
         "bsr_launches": bsr_launches})

    # ---- BSR timings at the irregular shape ---------------------------------
    # The plain versions densify the present blocks on every call: a
    # transient 4.3 GB at this shape, which the 80 GB card holds.
    x2d = x.reshape(-1, 128)
    yk = bsr_ops.bsr_spmv(st, x2d)
    yp = bsr_ops.bsr_spmv_plain(st, x2d)
    bsr_err = close(yk, yp, 1e-5, "irregular bsr kernel vs plain")
    R_lib = torch.sparse_csr_tensor(R.indptr, R.indices.to(torch.int64),
                                    R.data, size=R.shape,
                                    check_invariants=False)
    row_ids = R._get_row_ids()
    # Bytes of the work, each input read once and each output written
    # once: the stored nonzeros (values and column indices), indptr, x
    # (X) and y (Y), bcol and bptr; the same count bounds the library's
    # CSR product.
    csr_bytes = (R.nnz * (R.data.element_size() + R.indices.element_size())
                 + R.indptr.numel() * 8 + st.nblocks * 4 + (st.nbr + 1) * 8)
    bsr_bytes = csr_bytes + 2 * 4 * rows
    csr_rowids_ms = time_ms(lambda: spmv_ops.csr_spmv_rowids(
        R.data, R.indices, row_ids, x, rows))
    bsr_row = {
        "name": "bsr_spmv", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/bsr_spmv.cu",
        "replaces": "legate_sparse_tpu/ops/bsr.py:143",
        "launches": bsr_launches, "max_abs_err": bsr_err,
        "ms": time_ms(lambda: bsr_ops.bsr_spmv(st, x2d)),
        "plain_ms": time_ms(lambda: bsr_ops.bsr_spmv_plain(st, x2d), reps=5),
        **bound(bsr_bytes, 2 * R.nnz),
        "library_ms": time_ms(lambda: R_lib @ x),
        "shape": {"rows": rows, "blocks": st.nblocks, "nnz": R.nnz,
                  "dtype": "float32", "bytes": bsr_bytes},
    }
    log({"phase": "timing_bsr", **bsr_row,
         "csr_rowids_ms": csr_rowids_ms,
         "csr_rowids_vs_bsr": csr_rowids_ms / bsr_row["ms"]})
    del x2d, y, yk, yp

    X = torch.randn((rows, kX), generator=gen, device=dev)
    reset_counts()
    Y = R @ X
    sync()
    spmm_counts = read_counts()
    check(R.spmm_path == "bsr", f"irregular SpMM took {R.spmm_path}")
    check(spmm_counts["bsr_spmm"] > 0, "irregular SpMM launched no BSR SpMM "
          "kernel")
    X3 = X[:, :3].double().cpu().numpy()
    diff = np.abs(Y[:, :3].double().cpu().numpy() - R_sp @ X3)
    bsr_spmm_err = float(diff.max())
    check(bool(np.all(diff <= 1e-5 * (abs(R_sp) @ np.abs(X3)) + 1e-30)),
          f"irregular SpMM vs scipy f64: max |Δ| {bsr_spmm_err}")
    del R_sp, X3, diff
    log({"phase": "main_path_spmm_irregular", "rows": rows, "k": kX,
         "path": R.spmm_path,
         "spmm_max_abs_err_vs_scipy_f64": bsr_spmm_err,
         "launches": spmm_counts})
    Yk = bsr_ops.bsr_spmm(st, X)
    Yp = bsr_ops.bsr_spmm_plain(st, X)
    bsr_spmm_kernel_err = close(Yk, Yp, 1e-5, "irregular bsr SpMM vs plain")
    close(R_lib @ X, Yp, 1e-5, "library csr SpMM vs plain")
    del Yk, Yp
    nb_ = csr_bytes + 2 * 4 * rows * kX
    bsr_spmm_row = {
        "name": "bsr_spmm", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "legate_sparse_tpu/ops/bsr.py:198",
        "launches": spmm_counts["bsr_spmm"],
        "max_abs_err": bsr_spmm_kernel_err,
        "ms": time_ms(lambda: bsr_ops.bsr_spmm(st, X)),
        "plain_ms": time_ms(lambda: bsr_ops.bsr_spmm_plain(st, X), reps=5),
        **bound(nb_, 2 * R.nnz * kX),
        "library_ms": time_ms(lambda: R_lib @ X),
        "shape": {"rows": rows, "blocks": st.nblocks, "k": kX,
                  "nnz": R.nnz, "dtype": "float32", "bytes": nb_},
    }
    log({"phase": "timing_bsr_spmm", **bsr_spmm_row,
         "csr_rowids_ms": time_ms(lambda: spmv_ops.csr_spmm_rowids(
             R.data, R.indices, row_ids, X, rows))})
    del R, R_lib, st, x, X, Y, row_ids
    torch.cuda.empty_cache()

    # ---- 7. SpGEMM: banded (kernel) and general (ESC) -----------------------
    # examples/common.py::banded_matrix(2^24, 5): ones on 5 diagonals.
    N = 1 << 24
    half = 2
    cols = (np.tile(np.arange(-half, half + 1), N)
            + np.repeat(np.arange(N), 2 * half + 1))
    keep = (cols >= 0) & (cols < N)
    cols = cols[keep]
    counts = keep.reshape(N, 2 * half + 1).sum(axis=1)
    indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    ones = np.ones(cols.shape[0], dtype=np.float32)
    Ab = sparse.csr_array((ones, cols, indptr), shape=(N, N))
    Ab._get_dia()
    sync()
    reset_counts()
    t0 = time.perf_counter()
    C = Ab @ Ab
    sync()
    spgemm_s = time.perf_counter() - t0
    spgemm_counts = read_counts()
    check(Ab.spgemm_path == "dia-kernel",
          f"banded SpGEMM took {Ab.spgemm_path}")
    check(spgemm_counts["dia_spgemm"] > 0,
          "banded SpGEMM launched no DIA SpGEMM kernel")
    # A seeded sample of rows (the first and last among them) against
    # scipy's f64 product: small integers, so equal exactly.
    Ab_sp = sp.csr_array((ones.astype(np.float64), cols, indptr),
                         shape=(N, N))
    del cols, keep, counts, ones
    sel = np.unique(np.concatenate([[0, 1, N - 2, N - 1],
                                    rng.choice(N, 4092, replace=False)]))
    sel_t = torch.from_numpy(sel).to(dev)
    starts = C.indptr[sel_t]
    cnt = C.indptr[sel_t + 1] - starts
    total = int(cnt.sum())
    pos = (torch.repeat_interleave(starts - (torch.cumsum(cnt, 0) - cnt), cnt,
                                   output_size=total)
           + torch.arange(total, device=dev))
    sub = sp.csr_array((C.data[pos].double().cpu().numpy(),
                        C.indices[pos].cpu().numpy(),
                        np.concatenate([[0], np.cumsum(cnt.cpu().numpy())])),
                       shape=(sel.shape[0], N))
    ref = sp.csr_array(Ab_sp[sel] @ Ab_sp)
    ref.sort_indices()
    check(np.array_equal(sub.indptr, ref.indptr)
          and np.array_equal(sub.indices, ref.indices)
          and np.array_equal(sub.data, ref.data),
          "banded SpGEMM: sampled rows differ from scipy's f64 product")
    del Ab_sp, sub, ref, sel_t, starts, cnt, pos
    # The general route: the 1024x1024-grid Poisson operator (holes in
    # its band) squared through ESC, all of it against scipy.
    Pp = gmg_app.poisson2D(1024, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    Cp = Pp @ Pp
    sync()
    esc_s = time.perf_counter() - t0
    check(Pp.spgemm_path == "esc", f"Poisson SpGEMM took {Pp.spgemm_path}")
    Pp_sp = Pp.toscipy().astype(np.float64)
    ref = sp.csr_array(Pp_sp @ Pp_sp)
    ref.sort_indices()
    got = Cp.toscipy()
    check(np.array_equal(got.indptr, ref.indptr)
          and np.array_equal(got.indices, ref.indices)
          and np.array_equal(got.data.astype(np.float64), ref.data),
          "ESC SpGEMM: the Poisson square differs from scipy's f64 product")
    log({"phase": "main_path_spgemm", "rows": N, "nnz_a": Ab.nnz,
         "nnz_c": C.nnz, "path": Ab.spgemm_path, "spgemm_s": spgemm_s,
         "sampled_rows_vs_scipy_f64": int(sel.shape[0]),
         "launches": spgemm_counts,
         "esc": {"grid": "1024x1024", "rows": Pp.shape[0], "nnz_a": Pp.nnz,
                 "nnz_c": Cp.nnz, "path": Pp.spgemm_path, "seconds": esc_s,
                 "vs_scipy_f64": "equal"}})
    del Pp, Cp, Pp_sp, ref, got

    da = Ab._get_dia()
    offs_c = C._dia[1]
    nnz_c = C.nnz
    del C
    # Timed with B a distinct copy of A's band: with one tensor as both,
    # B's loads hit in L2 the bytes A just staged, and the bound would
    # count bytes that are never read from device memory.
    b_band = da[0].clone()
    spgemm_args = (da[1], da[1], offs_c, Ab.shape, Ab.shape)
    Ck = dia_kernel.dia_spgemm(da[0], b_band, *spgemm_args)
    Cpl = dia_kernel.dia_spgemm_plain(da[0], b_band, *spgemm_args)
    spgemm_kernel_err = close(Ck, Cpl, 1e-6, "banded SpGEMM kernel vs plain")
    check(torch.equal(Ck, Cpl), "banded SpGEMM kernel: not bitwise equal")
    del Ck, Cpl
    pairs = dia_kernel.spgemm_pairs(*spgemm_args)
    npairs = sum(map(len, pairs))
    nb_ = 4 * (2 * len(da[1]) * N + len(offs_c) * N)
    nops_ = 2 * sum(hi - lo for ps in pairs for (_, _, _, lo, hi) in ps)
    Ab_lib = torch.sparse_csr_tensor(Ab.indptr, Ab.indices.to(torch.int64),
                                     Ab.data, size=Ab.shape,
                                     check_invariants=False)
    dia_spgemm_row = {
        "name": "dia_spgemm", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/dia_spgemm.cu",
        "replaces": "legate_sparse_tpu/ops/pallas_dia.py:609",
        "launches": spgemm_counts["dia_spgemm"],
        "max_abs_err": spgemm_kernel_err,
        "ms": time_ms(lambda: dia_kernel.dia_spgemm(da[0], b_band,
                                                    *spgemm_args)),
        "plain_ms": time_ms(lambda: dia_kernel.dia_spgemm_plain(
            da[0], b_band, *spgemm_args)),
        **bound(nb_, nops_),
        "library_ms": time_ms(lambda: Ab_lib @ Ab_lib, reps=5),
        "shape": {"rows": N, "diags_a": len(da[1]), "diags_c": len(offs_c),
                  "pairs": npairs, "dtype": "float32", "bytes": nb_,
                  "b": "a distinct copy of A's band",
                  "variant": "tiled" if dia_kernel.spgemm_tiled_ok(
                      da[1], da[1], offs_c, npairs, Ab.shape, Ab.shape,
                      torch.float32) else "general"},
    }
    # The same INNER calls in a row under the profiler: the kernel's
    # device time beside its event time shows any host gap between the
    # calls, and the trace's copies and synchronisations show what a
    # call costs the stream (the loop ends on one event synchronize).
    prof = profile_calls(lambda: dia_kernel.dia_spgemm(da[0], b_band,
                                                       *spgemm_args),
                         "dia_spgemm")
    check(not prof["copies"]
          and sum(prof["synchronizations"].values()) < INNER,
          f"{INNER} dia_spgemm calls copied or synchronised per call: "
          f"{prof}")
    # ``A @ A`` as the main path runs it, one tensor as A and B: the
    # whole product (like for like with ``library_ms``, also a complete
    # CSR product) and its split, the kernel then ``band_to_csr``.
    Cd = dia_kernel.dia_spgemm(da[0], da[0], *spgemm_args)
    log({"phase": "timing_dia_spgemm", **dia_spgemm_row,
         "profiler": prof, "table_cache": str(
             dia_kernel.spgemm_table.cache_info()),
         "a_at_a_ms": time_ms(lambda: Ab @ Ab, reps=5),
         "a_at_a_split_ms": {
             "dia_spgemm_aliased": time_ms(lambda: dia_kernel.dia_spgemm(
                 da[0], da[0], *spgemm_args)),
             "band_to_csr": time_ms(lambda: dia_ops.band_to_csr(
                 Cd, offs_c, Ab.shape, nnz_c), reps=5)}})
    del Ab, Ab_lib, da, b_band, Cd
    torch.cuda.empty_cache()

    # ---- 8. GMG-preconditioned CG on the 4096x4096 Poisson grid -------------
    gmg_counts = {}

    @contextlib.contextmanager
    def counted():
        reset_counts()
        yield
        gmg_counts.update(read_counts())

    grid = 4096
    sol = gmg_app.solve(grid, 8, gridop="linear", tol=1e-5,
                        dtype=torch.float32, device=dev, maxiter=200,
                        compare_plain=True, plain_maxiter=40000,
                        watch=counted)
    sync()
    x_gmg = sol.pop("x")
    mg = sol.pop("gmg")
    hierarchy = gmg_app.print_diagnostics(mg.operators)
    check(bool(torch.isfinite(x_gmg).all()), "GMG-CG iterate must be finite")
    check(sol["iters"] < 200, f"GMG-CG did not converge in {sol['iters']}")
    check(sol["iters"] < sol["plain_iters"],
          f"GMG-CG took {sol['iters']} iterations, plain CG "
          f"{sol['plain_iters']}")
    check(sol["rel_residual"] <= max(1e-5, 2.0 * sol["residual_floor"]),
          f"GMG-CG true relative residual {sol['rel_residual']} (f32 floor "
          f"{sol['residual_floor']})")
    check(all(p == {"R@A": "esc", "RA@P": "esc"}
              for p in sol["spgemm_paths"]), "GMG products must take ESC")
    # Launches of the GMG-CG solve alone: A @ x for r0 and A @ p per
    # iteration; per iteration one V-cycle, which applies each level's
    # A twice and its R and P once, on every level above the coarsest.
    iters = sol["iters"]
    cycle = sol["spmv_paths"][:sol["levels"] - 1]
    want = {"dia_spmv": (iters + 1) * (cycle[0]["A"] == "dia-kernel")
            + iters * 2 * sum(p["A"] == "dia-kernel" for p in cycle),
            "bsr_spmv": iters * sum((p["R"] == "bsr") + (p["P"] == "bsr")
                                    for p in cycle)}
    check(want["dia_spmv"] > 0, "the GMG V-cycle has no DIA kernel path")
    for name, count in want.items():
        check(gmg_counts[name] == count,
              f"GMG-CG launched {name} {gmg_counts[name]} times, its "
              f"paths {sol['spmv_paths']} call for {count}")

    # Every level's Galerkin product R @ A @ P against scipy's f64
    # product of the same R, A and P, taken from the card, on a seeded
    # sample of its rows.  Each entry is held to 1e-5 of the sum of its
    # terms' magnitudes, (|R| |A| |P|): f32 rounding stays far below,
    # a lost or doubled ESC chunk far above.
    A_h = mg.A.toscipy().astype(np.float64)
    A_sp = A_h
    galerkin = []
    for level, (R_l, A_c, P_l) in enumerate(mg.operators):
        R_h = R_l.toscipy().astype(np.float64)
        P_h = P_l.toscipy().astype(np.float64)
        Ac_h = A_c.toscipy().astype(np.float64)
        sel = np.sort(rng.choice(A_c.shape[0], min(2048, A_c.shape[0]),
                                 replace=False))
        ref = sp.csr_array(R_h[sel] @ A_h) @ P_h
        mag = sp.csr_array(abs(R_h[sel]) @ abs(A_h)) @ abs(P_h)
        diff = abs(sp.csr_array(Ac_h[sel]) - ref)
        err = float(diff.max()) if diff.nnz else 0.0
        bad = diff - 1e-5 * mag
        check(not bad.nnz or float(bad.max()) <= 0.0,
              f"GMG level {level}: R @ A @ P differs from scipy's f64 "
              f"product by {err} on sampled rows")
        galerkin.append({"level": level, "rows": int(A_c.shape[0]),
                         "sampled_rows": int(sel.shape[0]),
                         "max_abs_err": err,
                         "max_magnitude": float(mag.max())})
        A_h = Ac_h
    del A_h, R_h, P_h, Ac_h, ref, mag, diff, bad

    # x against the exact solution of the f64 system, by the discrete
    # sine transform on the host: A = T (x) I + I (x) T with T =
    # tridiag(-1, 2, -1), whose eigenvectors are the DST-I basis.
    b64 = np.random.default_rng(0).random(grid * grid)
    lam = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, grid + 1) / (grid + 1))
    x_ref = fft.dstn(fft.dstn(b64.reshape(grid, grid), type=1, norm="ortho")
                     / (lam[:, None] + lam[None, :]), type=1,
                     norm="ortho").reshape(-1)
    ref_res = float(np.linalg.norm(A_sp @ x_ref - b64) / np.linalg.norm(b64))
    x_err = float(np.linalg.norm(x_gmg.double().cpu().numpy() - x_ref)
                  / np.linalg.norm(x_ref))
    # The first V-cycle builds every operator's structure caches.  With
    # the BSR blocks densified by a host-side pack it took 8.72-14.43 s
    # (H100 80GB HBM3, 700 W).
    log({"phase": "main_path_gmg", **sol,
         "first_cycle_s_with_host_bsr_pack": [8.72, 14.43],
         "launches": gmg_counts,
         "launches_expected": want, "galerkin_vs_scipy_f64": galerkin,
         "rel_error_to_exact": x_err, "exact_ref_rel_residual": ref_res,
         "hierarchy_report": hierarchy.splitlines()})
    # x is ~10^6 times b: the f64 rounding of x alone leaves ~5e-10.
    check(ref_res <= 1e-8, f"DST reference residual {ref_res}")
    check(x_err <= 1e-4, f"GMG-CG relative error to the exact solution "
          f"{x_err}")
    del x_gmg, sol, mg, A_sp, x_ref, b64
    torch.cuda.empty_cache()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log({"kernels": [{k: row[k] for k in keys}
                     for row in (dia_row, bsr_row, dia_spmm_row,
                                 bsr_spmm_row, dia_spgemm_row)]})
    print(smi_line, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
