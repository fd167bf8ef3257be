# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Preconditioner factories: point Jacobi and block Jacobi.

Mirrors ``legate_sparse_tpu/precond.py``: ``jacobi`` (``:109-129``)
and ``block_jacobi`` (``:53-106``, its blocks from ``_diag_blocks``
``:26-50``).  ``block_jacobi`` scatters the in-block entries of a CSR
matrix into ``(nb, bs, bs)`` dense diagonal blocks, inverts them in one
batched dense solve (``torch.linalg.solve_ex``) and applies them as one
batched matrix-vector product (``torch.bmm``), all on the matrix's
device, so the apply makes no host sync inside a solver's loop.
"""

from __future__ import annotations

import torch

__all__ = ["block_jacobi", "jacobi"]


def _diag_blocks(A, bs: int) -> torch.Tensor:
    """(nb, bs, bs) dense diagonal blocks of a ``csr_array``.

    Only the in-block entries are scattered (``compact_mask``, one host
    sync): the JAX package scatters every entry, the others with value
    0, and on CUDA an accumulating scatter is atomic, so this moves
    fewer bytes and, on a matrix without duplicates, adds each slot
    once.  Duplicates add up, as they do there."""
    from .ops.convert import compact_mask

    n = A.shape[0]
    nb = (n + bs - 1) // bs
    row_ids = A._get_row_ids().to(torch.int64)
    cols = A.indices.to(torch.int64)
    rows_in, cols_in, vals = compact_mask(row_ids // bs == cols // bs,
                                          (row_ids, cols, A.data))
    blocks = torch.zeros((nb, bs, bs), dtype=A.dtype, device=A.device)
    blocks.index_put_((rows_in // bs, rows_in % bs, cols_in % bs), vals,
                      accumulate=True)
    # The padding rows of the last, partial block get the identity, so
    # the batched solve stays nonsingular and the padding inert.
    pad = nb * bs - n
    if pad:
        tail = torch.arange(bs - pad, bs, device=A.device)
        blocks[nb - 1, tail, tail] += 1
    return blocks


def block_jacobi(A, block_size: int = 32):
    """Block-Jacobi preconditioner ``M ~= A^-1`` as a ``LinearOperator``.

    Inverts the ``block_size`` dense diagonal blocks of ``A`` in one
    batched solve at construction; each apply is one batched (nb, bs,
    bs) x (nb, bs) product.  A singular block raises ``ValueError``,
    whether the solve reports it (``info``) or returns non-finite
    values; so does a non-square ``A``."""
    from .gallery import _as_csr
    from .linalg import LinearOperator

    n, m = A.shape
    if n != m:
        raise ValueError("block_jacobi needs a square matrix")
    bs = int(block_size)
    if bs < 1:
        raise ValueError("block_size must be >= 1")
    A = _as_csr(A)
    if bs == 1:
        return jacobi(A)

    nb = (n + bs - 1) // bs
    blocks = _diag_blocks(A, bs)
    eye = torch.eye(bs, dtype=A.dtype, device=A.device).expand(nb, bs, bs)
    inv_blocks, info = torch.linalg.solve_ex(blocks, eye)
    del blocks
    if bool((info != 0).any()) or not bool(torch.isfinite(inv_blocks).all()):
        raise ValueError(
            "block_jacobi: a diagonal block is singular "
            f"(block_size={bs}); regularize A or change block_size")
    pad = nb * bs - n

    def _apply(B3, x):
        dt = torch.promote_types(B3.dtype, x.dtype)
        xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
        y = torch.bmm(B3.to(dt), xp.to(dt).reshape(nb, bs, 1)).reshape(-1)
        return y[:n] if pad else y

    def matvec(x):
        return _apply(inv_blocks, x)

    def rmatvec(x):
        # M is block diagonal: its adjoint is the per-block conjugate
        # transpose.
        return _apply(inv_blocks.transpose(1, 2).conj(), x)

    return LinearOperator((n, n), matvec=matvec, rmatvec=rmatvec,
                          dtype=A.dtype)


def jacobi(A):
    """Diagonal (point-Jacobi) preconditioner ``M = diag(A)^-1``.  A
    zero on the diagonal raises ``ValueError``, like a zero pivot."""
    from .gallery import _as_csr
    from .linalg import LinearOperator

    n, m = A.shape
    if n != m:
        raise ValueError("jacobi needs a square matrix")
    d = _as_csr(A).diagonal()
    if bool((d == 0).any()):
        raise ValueError("jacobi: zero on the diagonal")
    dinv = 1.0 / d

    def matvec(x):
        return dinv * x

    def rmatvec(x):
        return dinv.conj() * x

    return LinearOperator((n, n), matvec=matvec, rmatvec=rmatvec,
                          dtype=d.dtype)
