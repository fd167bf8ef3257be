#!/usr/bin/env python3
# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: both CUDA kernels from ``legate_sparse_tpu_torch/csrc`` (one
   nvcc each, started together) and their seconds;
3. kernels against their plain PyTorch versions on the card: DIA (f32
   exact band, f32 holey band with inf/NaN in x at holes and out of
   the band's reach, rectangular, offsets past ±128 and ±2^17, bf16)
   and BSR (f32, bf16);
4. main path at full size: the 4096x4096-grid 5-point Poisson operator
   (16,777,216 unknowns, f32) built by ``diags(...)`` in CSR on the
   card; ``A @ x`` through ``"dia-kernel"`` against scipy's f64 SpMV,
   the explicit update ``v - 0.25*(A@v) + b``, 500 CG iterations
   (one DIA launch per iteration plus one for ``r0``), and the pde
   app solved to tolerance on a 512x512 grid;
5. irregular SpMV at 2^20 rows, 8 present 128x128 blocks per block-row
   (65,536 blocks), 16 nonzeros per row, f32, from seed 0: ``A @ x``
   through ``"bsr"`` against scipy's f64 SpMV;
6. for each kernel at the shapes of phases 4 and 5: its time (CUDA
   events, median of 25 after warmup), the least time the card could
   take (bytes over 3.35 TB/s, operations over 67 TFLOP/s f32), the
   plain version's time and one PyTorch library call's time
   (``torch.sparse_csr_tensor @ x``, a yardstick the port never calls).

Launch counts come from the kernel wrappers: each is set to 0 just
before a main-path phase drives the path and read just after.  Any
failed check raises, so the script exits non-zero; it exits non-zero
without printing a result when there is no CUDA device.  The last three
lines are the ``kernels`` JSON object, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
import warnings

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, f32 outside tensor cores
REPS = 25


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

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import linalg
    from legate_sparse_tpu_torch.apps import pde
    from legate_sparse_tpu_torch.ops import _build
    from legate_sparse_tpu_torch.ops import bsr as bsr_ops
    from legate_sparse_tpu_torch.ops import dia_kernel
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

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        sync()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

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

    bsr_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        d, i, p = block_clustered(1 << 16, 8, 2)
        B = sparse.csr_array((d, i, p), shape=(1 << 16, 1 << 16),
                             dtype=dtype)
        st = B._get_bsr()
        check(st is not None, f"BSR {dtype}: structure must build")
        x2d = randx(1 << 16, dtype).reshape(-1, 128)
        y = bsr_ops.bsr_spmv(st.blkT, st.brow, st.bcol, st.bptr, x2d, st.nbr)
        yp = bsr_ops.bsr_spmv_plain(st.blkT, st.brow, st.bcol, x2d, st.nbr)
        err = close(y, yp, 1e-5, f"bsr-{dtype}")
        bsr_cases.append({"case": f"bsr-{str(dtype).split('.')[-1]}",
                          "rows": 1 << 16, "blocks": st.nblocks,
                          "max_abs_err": err})
        del B, st
    log({"phase": "kernels_vs_plain", "dia": cases, "bsr": bsr_cases})
    del H, xh, yh
    torch.cuda.empty_cache()

    # ---- 4. main path: pde_4096 -------------------------------------------
    dia_kernel.dia_spmv.launches = 0
    bsr_ops.bsr_spmv.launches = 0
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
    del A_sp, y_ref, mag, xn

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
    dia_ops_count = 2 * nd * n
    dia_bound = max(dia_bytes / HBM_BYTES_PER_S,
                    dia_ops_count / F32_OPS_PER_S) * 1e3
    dia_row = {
        "name": "dia_spmv", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "legate_sparse_tpu/ops/pallas_dia.py:312",
        "launches": dia_launches, "max_abs_err": dia_err,
        "ms": time_ms(lambda: dia_kernel.dia_spmv(packed, x)),
        "plain_ms": time_ms(lambda: dia_kernel.dia_spmv_plain(
            packed.rdata, packed.rmask, x, packed.offsets, packed.shape)),
        "bound_ms": dia_bound,
        "bound_by": ("bytes" if dia_bytes / HBM_BYTES_PER_S
                     >= dia_ops_count / F32_OPS_PER_S else "operations"),
        "library_ms": time_ms(lambda: A_lib @ x),
        "shape": {"rows": n, "diags": nd, "masked": True, "dtype": "float32",
                  "bytes": dia_bytes},
    }
    log({"phase": "timing_dia", **dia_row})
    del A, A_lib, packed, x, y, yk, yp, y_lib, b, v
    torch.cuda.empty_cache()

    # ---- 5. irregular SpMV through BSR --------------------------------------
    rows = 1 << 20
    d, i, p = block_clustered(rows, 8, 2)
    R = sparse.csr_array((d, i, p), shape=(rows, rows))
    x = randx(rows)
    dia_kernel.dia_spmv.launches = 0
    bsr_ops.bsr_spmv.launches = 0
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
    del R_sp, xn, diff
    st = R._get_bsr()
    log({"phase": "main_path_irregular", "rows": rows, "nnz": R.nnz,
         "blocks": st.nblocks, "path": R.spmv_path,
         "pack_and_first_spmv_s": bsr_first_s,
         "spmv_max_abs_err_vs_scipy_f64": bsr_spmv_err,
         "bsr_launches": bsr_launches})

    # ---- 6b. BSR timings at the irregular shape ------------------------------
    x2d = x.reshape(-1, 128)
    yk = bsr_ops.bsr_spmv(st.blkT, st.brow, st.bcol, st.bptr, x2d, st.nbr)
    yp = bsr_ops.bsr_spmv_plain(st.blkT, st.brow, st.bcol, x2d, st.nbr)
    bsr_err = close(yk, yp, 1e-5, "irregular bsr kernel vs plain")
    R_lib = torch.sparse_csr_tensor(R.indptr, R.indices.to(torch.int64),
                                    R.data, size=R.shape,
                                    check_invariants=False)
    row_ids = R._get_row_ids()
    bsr_bytes = (st.nblocks * 128 * 128 * 4 + st.nblocks * 4
                 + (st.nbr + 1) * 8 + 4 * rows + 4 * rows)
    bsr_ops_count = 2 * st.nblocks * 128 * 128
    bsr_bound = max(bsr_bytes / HBM_BYTES_PER_S,
                    bsr_ops_count / F32_OPS_PER_S) * 1e3
    csr_rowids_ms = time_ms(lambda: spmv_ops.csr_spmv_rowids(
        R.data, R.indices, row_ids, x, rows))
    bsr_row = {
        "name": "bsr_spmv", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/bsr_spmv.cu",
        "replaces": "legate_sparse_tpu/ops/bsr.py:143",
        "launches": bsr_launches, "max_abs_err": bsr_err,
        "ms": time_ms(lambda: bsr_ops.bsr_spmv(st.blkT, st.brow, st.bcol,
                                               st.bptr, x2d, st.nbr)),
        "plain_ms": time_ms(lambda: bsr_ops.bsr_spmv_plain(
            st.blkT, st.brow, st.bcol, x2d, st.nbr)),
        "bound_ms": bsr_bound,
        "bound_by": ("bytes" if bsr_bytes / HBM_BYTES_PER_S
                     >= bsr_ops_count / F32_OPS_PER_S else "operations"),
        "library_ms": time_ms(lambda: R_lib @ x),
        "shape": {"rows": rows, "blocks": st.nblocks, "nnz": R.nnz,
                  "dtype": "float32", "bytes": bsr_bytes},
    }
    log({"phase": "timing_bsr", **bsr_row,
         "csr_rowids_ms": csr_rowids_ms,
         "csr_rowids_vs_bsr": csr_rowids_ms / bsr_row["ms"]})
    del R, R_lib, st, x, x2d, y, yk, yp, row_ids
    torch.cuda.empty_cache()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log({"kernels": [{k: row[k] for k in keys}
                     for row in (dia_row, bsr_row)]})
    print(smi_line, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
