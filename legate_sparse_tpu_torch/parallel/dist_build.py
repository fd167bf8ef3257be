# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Sharded construction of banded matrices: each rank builds its own
row block on its own device, and the global CSR is never formed.

Counterpart of ``legate_sparse_tpu/parallel/dist_build.py`` (``:1-252``):
``band_ell_local``, ``dist_diags`` (scalar, callable and array
diagonals, scipy ``diags`` semantics) and ``dist_poisson2d``.  A
callable diagonal takes a torch int64 tensor of element indices on the
rank's device (the JAX package's takes a traced ``jnp`` array).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import numpy as np
import torch

from ..types import coord_dtype_for, to_torch_dtype
from .dist_csr import DistCSR, attach_dia_prepack
from .mesh import ROW_AXIS, make_row_mesh, mesh_device

DiagSpec = Union[float, int, np.ndarray, Callable]


def band_ell_local(vals_by_diag, offs_dev, n: int, rps: int, halo: int,
                   start: int, r, r_l):
    """One shard's full band -> ELL (``dist_build.py:39``): from
    row-indexed diagonal values ``vals_by_diag`` (W, rps) and sorted
    offsets, ``(ell_data, ell_cols, cnt)`` with the padded-slot
    conventions of ``ell_pack`` (a padding slot repeats the row's last
    column with value 0) and columns rebased to the halo window when
    ``halo >= 0``."""
    W = vals_by_diag.shape[0]
    lo = torch.searchsorted(offs_dev, -r, right=False)
    hi = torch.searchsorted(offs_dev, n - r, right=False)
    cnt = torch.where(r < n, hi - lo, 0).to(torch.int32)
    slot = torch.arange(W, dtype=torch.int32, device=r.device)
    valid = slot[None, :] < cnt[:, None]
    d_idx = torch.clamp(
        lo[:, None] + torch.minimum(slot[None, :],
                                    torch.clamp_min(cnt[:, None] - 1, 0)),
        0, W - 1)
    col = torch.clamp(r[:, None] + offs_dev[d_idx], 0, n - 1)
    zero = torch.zeros((), dtype=vals_by_diag.dtype, device=r.device)
    ell_data = torch.where(valid, vals_by_diag[d_idx, r_l[:, None]], zero)
    if halo >= 0:
        ell_cols = torch.clamp(col - (start - halo), 0,
                               rps + 2 * halo - 1).to(torch.int32)
    else:
        ell_cols = col.to(coord_dtype_for(n))
    return ell_data, ell_cols, cnt


def dist_diags(diagonals: Sequence[DiagSpec], offsets: Sequence[int],
               shape, mesh=None, dtype=np.float64,
               materialize_ell: bool = True) -> DistCSR:
    """Banded ``DistCSR`` built shard by shard (``dist_build.py:77``).

    Each diagonal is a scalar, a callable ``f(i)`` of the diagonal's
    element indices (element ``i`` sits at ``(i, i+k)`` for ``k >= 0``,
    ``(i-k, i)`` for ``k < 0``), or an array of length ``n - |k|``, of
    which each rank reads its own rows.  The result is the ELL layout
    ``shard_csr`` gives a banded matrix, with the DIA blocks and their
    kernel pack in halo mode; ``materialize_ell=False`` (halo mode only)
    keeps the DIA blocks alone."""
    if mesh is None:
        mesh = make_row_mesh()
    rows, cols = int(shape[0]), int(shape[1])
    if rows != cols:
        raise NotImplementedError("dist_diags requires a square shape")
    n = rows
    order = np.argsort(np.asarray(offsets, dtype=np.int64), kind="stable")
    offs = np.asarray(offsets, dtype=np.int64)[order]
    diags_sorted = [diagonals[i] for i in order]
    if len(set(offs.tolist())) != len(offs):
        raise ValueError("duplicate offsets")
    R = mesh.size(0)
    rps = math.ceil(n / R) if n else 1
    s = mesh.get_local_rank(ROW_AXIS)
    start = s * rps
    reach = int(max(offs.max(initial=0), -offs.min(initial=0)))
    halo = reach if reach <= rps else -1
    if not materialize_ell and halo < 0:
        raise ValueError(
            "materialize_ell=False requires halo mode "
            f"(band reach {reach} > rows-per-shard {rps})")
    tdtype = to_torch_dtype(dtype)
    dev = mesh_device(mesh)
    r_l = torch.arange(rps, dtype=torch.int64, device=dev)
    r = start + r_l

    # vals[d, r_l] = value of diagonal d at global row start + r_l.
    vals = []
    for k, spec in zip(offs.tolist(), diags_sorted):
        if callable(spec):
            i = torch.clamp(r + min(k, 0), 0, max(n - abs(k) - 1, 0))
            vals.append(torch.as_tensor(spec(i), device=dev).to(tdtype)
                        .expand(rps))
            continue
        arr = np.asarray(spec)
        if arr.ndim == 0:
            vals.append(torch.full((rps,), float(arr), dtype=tdtype,
                                   device=dev))
            continue
        L = n - abs(k)
        if arr.shape[0] != L:
            raise ValueError(
                f"diagonal {k} has length {arr.shape[0]}, expected {L}")
        block = np.zeros(rps, dtype=arr.dtype)
        i_lo = start + min(k, 0)
        o_lo, o_hi = max(i_lo, 0), min(i_lo + rps, L)
        if o_hi > o_lo:
            block[o_lo - i_lo:o_hi - i_lo] = arr[o_lo:o_hi]
        vals.append(torch.from_numpy(block).to(dev, tdtype))
    vals_by_diag = torch.stack(vals)                       # (W, rps)
    offs_dev = torch.as_tensor(offs, device=dev)

    data = cols_b = counts = dia_data = None
    if materialize_ell:
        data, cols_b, counts = band_ell_local(vals_by_diag, offs_dev, n,
                                              rps, halo, start, r, r_l)
    if halo >= 0:
        tgt = r[:, None] + offs_dev[None, :]
        in_range = (tgt >= 0) & (tgt < n) & (r[:, None] < n)
        dia_data = torch.where(in_range.T, vals_by_diag,
                               torch.zeros((), dtype=tdtype, device=dev))
    return attach_dia_prepack(DistCSR(
        data=data, cols=cols_b, counts=counts, row_ids=None, shape=(n, n),
        rows_per_shard=rps, halo=halo, ell=True, mesh=mesh,
        dia_data=dia_data,
        dia_offsets=(tuple(int(o) for o in offs.tolist())
                     if halo >= 0 else None),
        nnz_hint=sum(n - abs(int(k)) for k in offs.tolist())))


def dist_poisson2d(N: int, mesh=None, dtype=np.float64,
                   materialize_ell: bool = True) -> DistCSR:
    """5-point 2-D Poisson operator on an N x N grid, built on each
    rank's device from the boundary pattern alone."""
    n = N * N

    def off1(i):
        # Coupling (i, i+1) is zero across grid-row boundaries.
        return torch.where((i + 1) % N == 0, 0.0, -1.0)

    return dist_diags([4.0, off1, off1, -1.0, -1.0], [0, 1, -1, N, -N],
                      shape=(n, n), mesh=mesh, dtype=dtype,
                      materialize_ell=materialize_ell)
