# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Spectral graph analysis on the port: the port of ``examples/spectral.py``.

On a random block-model graph (``clustered_graph``, built on the host
by scipy from ``default_rng(0)``): its connected components
(``csgraph.connected_components``), the normalised Laplacian
(``csgraph.laplacian(normed=True)``) and its ``-k`` smallest eigenpairs
(``linalg.eigsh(which="SA")``).  The number of near-zero eigenvalues
equals the number of components, and the gap after the cluster count
shows the planted structure.  ``--package scipy`` runs the same script
on host scipy; the calls line up one to one.  Run it as::

    python -m legate_sparse_tpu_torch.apps.spectral -n 4000 --clusters 4 \
        [--package scipy] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy

from .common import parse_common_args


def clustered_graph(n: int, clusters: int, p_in: float, p_out: float, rng):
    """Sparse block-model adjacency (scipy CSR, float64): dense-ish within
    clusters, sparse across."""
    import scipy.sparse as host_sparse

    size = n // clusters
    blocks = []
    for i in range(clusters):
        row = []
        for j in range(clusters):
            p = p_in if i == j else p_out
            row.append(host_sparse.random(size, size, density=p,
                                          format="coo", random_state=rng))
        blocks.append(row)
    A = host_sparse.bmat(blocks, format="csr")
    A = ((A + A.T) > 0).astype(numpy.float64)
    A.setdiag(0)
    A.eliminate_zeros()
    return A.tocsr()


def run(h, n: int = 4000, clusters: int = 4, k: int = 6,
        p_in: float = 0.02, p_out: float = 0.0005) -> dict:
    """The pipeline on the harness's package, on ``clustered_graph(n,
    clusters, p_in, p_out, default_rng(0))``; prints the example's lines
    and returns the component count and labels, the sorted eigenvalues,
    the near-zero count, the gap and each step's ms."""
    rng = numpy.random.default_rng(0)
    host_A = clustered_graph(n, clusters, p_in=p_in, p_out=p_out, rng=rng)
    if h.package == "scipy":
        A = h.sparse.csr_array(host_A)
        import scipy.sparse.csgraph as csgraph
    else:
        A = h.sparse.csr_array(host_A, device=h.device)
        from .. import csgraph
    print(f"graph: {A.shape[0]} nodes, {A.nnz} edges ({clusters} planted "
          f"clusters), package={h.package}", flush=True)

    h.timer.start()
    ncomp, labels = csgraph.connected_components(A, directed=False)
    t_cc = h.timer.stop()
    print(f"connected components: {ncomp}  [{t_cc:.1f} ms]", flush=True)

    h.timer.start()
    L = csgraph.laplacian(A, normed=True)
    t_lap = h.timer.stop()

    h.timer.start()
    w, _V = h.linalg.eigsh(L, k=k, which="SA")
    t_eig = h.timer.stop()
    w = numpy.sort(numpy.asarray(w.cpu() if hasattr(w, "cpu") else w,
                                 dtype=numpy.float64))
    print(f"laplacian [{t_lap:.1f} ms]; eigsh k={k} SA [{t_eig:.1f} ms]")
    print("smallest normalized-Laplacian eigenvalues:", numpy.round(w, 5))
    # The number of near-zero eigenvalues equals the number of connected
    # components; the gap after the cluster count reflects the planted
    # structure.
    near_zero = int((w < 1e-8).sum())
    print(f"near-zero eigenvalues: {near_zero} "
          f"(= components: {near_zero == int(ncomp)})")
    gap = None
    if clusters < k:
        gap = float(w[clusters] - w[clusters - 1])
        print(f"spectral gap after {clusters} clusters: {gap:.4f}",
              flush=True)
    labels = numpy.asarray(labels.cpu() if hasattr(labels, "cpu")
                           else labels)
    return {"n": int(A.shape[0]), "nnz": int(A.nnz),
            "components": int(ncomp), "labels": labels, "eigenvalues": w,
            "near_zero": near_zero, "gap": gap, "cc_ms": t_cc,
            "laplacian_ms": t_lap, "eigsh_ms": t_eig,
            "laplacian_path": getattr(L, "spmv_path", None)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-n", type=int, default=4000)
    parser.add_argument("--clusters", type=int, default=4)
    parser.add_argument("-k", type=int, default=6,
                        help="eigenpairs to compute")
    args, _ = parser.parse_known_args(argv)
    h = parse_common_args(argv)
    with h.profiling():
        return run(h, args.n, args.clusters, args.k)


if __name__ == "__main__":
    main()
