# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""SpGEMM microbenchmark on the port.

The port of ``examples/spgemm_microbenchmark.py``: ``A @ B`` for the
banded matrix ``banded_matrix(-n, --nnz-per-row)`` squared (B a copy of
A), or for the Matrix Market files ``--filename1``/``--filename2``
(B = A when only the first is given).  ``--stable`` reuses one pair of
matrices (their cached structure) for 5 warm-ups and ``-i`` timed
products; without it every product gets freshly built matrices and only
the product is timed.  ``--distributed`` squares the banded matrix with
``parallel.dist_spgemm`` over ``--ranks`` ranks started by
``parallel.launch.run_ranks``: NCCL ranks on ``cuda`` (one a card),
gloo ranks on the CPU.  It prints the example's lines::

    SPGEMM (N, N)x(N, N) , nnz (a)x(b)->(c) : ms / iteration: t
    SPGEMM (distributed, band) (N, N)x(N, N) over R devices : ms / iteration: t

Run it as::

    python -m legate_sparse_tpu_torch.apps.spgemm_microbenchmark \
        -n 16m --nnz-per-row 5 --dtype float32 -i 10 [--stable] \
        [--distributed [--ranks R]] [--package scipy] [--device cpu]
"""

from __future__ import annotations

import argparse

from .common import (TorchTimer, banded_matrix, get_arg_number,
                     parse_common_args)


def get_matrices(N, nnz_per_row, fname1, fname2, h):
    """(A, B): the files' matrices, or the banded matrix and its copy."""
    if fname1:
        if h.package == "scipy":
            import scipy.io

            def read(f):
                return h.sparse.csr_array(scipy.io.mmread(f))
        else:
            from ..io import mmread

            def read(f):
                return mmread(f, device=h.device)
        A = read(fname1)
        B = read(fname2) if fname2 else A.copy()
        return A, B
    A = banded_matrix(N, nnz_per_row, package=h.package, device=h.device,
                      dtype=h.dtype)
    return A, A.copy()


def run_spgemm(N, nnz_per_row, fname1, fname2, iters, stable, h) -> dict:
    """Time ``iters`` products (after 5 warm-ups) and print the example's
    line; returns the last iteration's operands and product, its route
    and the ms per product."""
    warmup = 5
    if stable:
        A, B = get_matrices(N, nnz_per_row, fname1, fname2, h)
        C = None
        for _ in range(warmup):
            C = A @ B
        h.timer.start()
        for _ in range(iters):
            C = A @ B
        total = h.timer.stop(C)
    else:
        total = 0.0
        for i in range(iters + warmup):
            A, B = get_matrices(N, nnz_per_row, fname1, fname2, h)
            h.timer.start()
            C = A @ B
            t = h.timer.stop(C)
            if i >= warmup:
                total += t
    print(f"SPGEMM {tuple(A.shape)}x{tuple(B.shape)} , nnz ({A.nnz})x"
          f"({B.nnz})->({C.nnz}) : ms / iteration: {total / iters}",
          flush=True)
    return {"A": A, "B": B, "C": C,
            "path": getattr(A, "spgemm_path", None),
            "ms_per_iter": total / iters}


def _distributed_rank(rank, world, N, nnz_per_row, iters, dtype,
                      return_c):
    """One rank of ``run_spgemm_distributed``: rank 0's record."""
    from .. import parallel as P, runtime
    from ..parallel.mesh import device_type

    if device_type() == "cpu":
        runtime.set_device("cpu")
    mesh = P.make_row_mesh()
    device = runtime.default_device()
    A = banded_matrix(N, nnz_per_row, device=device, dtype=dtype)
    dA = P.shard_csr(A, mesh=mesh)
    dB = P.shard_csr(A.copy(), mesh=mesh)
    C = None
    for _ in range(5):
        C = P.dist_spgemm(dA, dB)
    timer = TorchTimer(device)
    timer.start()
    for _ in range(iters):
        C = P.dist_spgemm(dA, dB)
    total = timer.stop()
    out = {"ms_per_iter": total / iters,
           "path": "band" if C.dia_data is not None else "esc",
           "shape": tuple(A.shape), "ranks": world}
    if return_c:
        Cg = C.to_csr()
        if rank == 0:
            out["C"] = tuple(t.cpu().numpy() for t in
                             (Cg.data, Cg.indices, Cg.indptr))
    return out


def run_spgemm_distributed(N, nnz_per_row, iters, ranks, h,
                           return_c=False) -> dict:
    """The banded product over ``ranks`` ranks (NCCL on ``cuda``, gloo
    on the CPU), printed as the example prints it; rank 0's record
    (with ``return_c``, the product's (data, indices, indptr))."""
    from ..parallel.launch import run_ranks

    backend = "nccl" if h.device.type == "cuda" else "gloo"
    rec = run_ranks(_distributed_rank, ranks, backend=backend,
                    timeout=900,
                    args=(N, nnz_per_row, iters, h.dtype, return_c))[0]
    print(f"SPGEMM (distributed, {rec['path']}) {rec['shape']}x"
          f"{rec['shape']} over {ranks} devices : ms / iteration: "
          f"{rec['ms_per_iter']}", flush=True)
    return rec


def main(argv=None) -> dict:
    """Run the benchmark; returns ``run_spgemm``'s (or the distributed
    run's) record."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-n", "--nrows", type=str, default="1k", dest="n")
    parser.add_argument("--nnz-per-row", type=int, default=5,
                        dest="nnz_per_row")
    parser.add_argument("--stable", action="store_true")
    parser.add_argument("--filename1", dest="fname_first", type=str,
                        default="")
    parser.add_argument("--filename2", dest="fname_second", type=str,
                        default="")
    parser.add_argument("-i", "--iters", type=int, default=100)
    parser.add_argument("--distributed", action="store_true",
                        help="the banded product over the ranks "
                        "(--package torch only)")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks of --distributed (default: the "
                        "visible cards on cuda, 1 on the CPU)")
    args, _ = parser.parse_known_args(argv)
    h = parse_common_args(argv)
    with h.profiling():
        if args.distributed:
            if h.package != "torch":
                raise SystemExit("--distributed requires --package torch")
            if args.stable or args.fname_first or args.fname_second:
                raise SystemExit(
                    "--distributed benchmarks the banded config only; "
                    "--stable/--filename1/--filename2 are not supported")
            ranks = args.ranks
            if ranks is None:
                import torch

                ranks = (torch.cuda.device_count()
                         if h.device.type == "cuda" else 1)
            return run_spgemm_distributed(get_arg_number(args.n),
                                          args.nnz_per_row, args.iters,
                                          ranks, h)
        return run_spgemm(get_arg_number(args.n), args.nnz_per_row,
                          args.fname_first, args.fname_second, args.iters,
                          args.stable, h)


if __name__ == "__main__":
    main()
