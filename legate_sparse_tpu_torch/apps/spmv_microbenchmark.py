# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""SpMV microbenchmark: a banded matrix over a sweep of sizes, on the port.

The port of ``examples/spmv_microbenchmark.py``.  For each N from
``--nmin`` to ``--nmax`` (doubling) it builds ``banded_matrix(N,
--nnz-per-row)`` (or the matrix of ``-f FILE``, read by the port's
``io.mmread``), runs 5 warm-up products and then ``-i`` timed ones, the
device fenced at both ends, and prints::

    SPMV rows: <N>, nnz: <nnz> , ms / iter: <t>

``--repartition`` alternates ``A @ x`` and ``A @ y``; ``--use-out``
writes into a preallocated output (``A.dot(x, out=y)``); ``-d`` builds
the matrix through ``diags(...)``.  Run it as::

    python -m legate_sparse_tpu_torch.apps.spmv_microbenchmark \
        --nmin 16m --nmax 16m --nnz-per-row 11 --dtype float32 \
        [--package scipy] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy

from .common import banded_matrix, get_arg_number, parse_common_args


def spmv_dispatch(A, x, y, i, repartition, use_out):
    """The ``i``-th product of the loop: ``A @ x``, or ``A @ y`` on odd
    ``i`` with ``repartition``; with ``use_out`` into the other vector."""
    if use_out:
        if repartition and i % 2:
            A.dot(y, out=x)
            return x
        A.dot(x, out=y)
        return y
    if repartition and i % 2:
        return A @ y
    return A @ x


def run_spmv(A, iters, repartition, h, use_out) -> dict:
    """Time ``iters`` products of ``A`` (after 5 warm-ups) and print the
    example's line; returns rows, nnz, ms per product, the last product
    and the path it took."""
    if use_out and h.package == "scipy":
        raise ValueError("--use-out needs --package torch: scipy's dot "
                         "has no out=")
    if repartition and A.shape[0] != A.shape[1]:
        raise ValueError("--repartition needs a square matrix")
    if h.package == "scipy":
        x = numpy.ones((A.shape[1],), dtype=A.dtype)
        y = numpy.zeros((A.shape[0],), dtype=A.dtype)
    else:
        import torch

        x = torch.ones((A.shape[1],), dtype=A.dtype, device=A.device)
        y = torch.zeros((A.shape[0],), dtype=A.dtype, device=A.device)

    last = None
    for i in range(5):
        last = spmv_dispatch(A, x, y, i, repartition, use_out)
    h.timer.start()
    for i in range(iters):
        last = spmv_dispatch(A, x, y, i, repartition, use_out)
    total = h.timer.stop(last)
    print(f"SPMV rows: {A.shape[0]}, nnz: {A.nnz} , ms / iter: "
          f"{total / iters}", flush=True)
    return {"rows": int(A.shape[0]), "nnz": int(A.nnz),
            "ms_per_iter": total / iters, "y": last,
            "path": getattr(A, "spmv_path", None)}


def main(argv=None) -> list:
    """Run the sweep; returns ``run_spmv``'s record of each size."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nmin", type=str, default="1k")
    parser.add_argument("--nmax", type=str, default="1k")
    parser.add_argument("--nnz-per-row", type=int, default=11,
                        dest="nnz_per_row")
    parser.add_argument("--repartition", action="store_true")
    parser.add_argument("-f", "--filename", dest="fname", type=str,
                        default="")
    parser.add_argument("-i", "--iters", type=int, default=100)
    parser.add_argument("-d", "--from-diags", action="store_true",
                        dest="from_diags")
    parser.add_argument("--use-out", action="store_true", dest="use_out",
                        help="write into a preallocated output vector")
    args, _ = parser.parse_known_args(argv)
    h = parse_common_args(argv)
    records = []
    with h.profiling():
        if args.fname:
            if h.package == "scipy":
                import scipy.io

                A = h.sparse.csr_array(scipy.io.mmread(args.fname))
            else:
                from ..io import mmread

                A = mmread(args.fname, device=h.device)
            records.append(run_spmv(A, args.iters, args.repartition, h,
                                    args.use_out))
        else:
            N = get_arg_number(args.nmin)
            while N <= get_arg_number(args.nmax):
                A = banded_matrix(N, args.nnz_per_row, args.from_diags,
                                  package=h.package, device=h.device,
                                  dtype=h.dtype)
                records.append(run_spmv(A, args.iters, args.repartition, h,
                                        args.use_out))
                N *= 2
    return records


if __name__ == "__main__":
    main()
