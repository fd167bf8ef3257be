# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Candidate-kernel registry: what the autotuner may race and route
(the port of ``legate_sparse_tpu/autotune/registry.py``).

One :class:`Candidate` per routable kernel family, keyed by its dispatch
label (the label ``csr_array.dot`` records in ``spmv_path`` and its
span's ``path``).  Each entry names its ``ops/spmv.py`` function, the
ops it serves, a structural ``eligible`` predicate (False skips the
candidate, never errors) and the ``run`` closure the harness times and
routing serves.  All ten are the JAX package's; each runs the port's
function of the same name.

Deliberately absent: DIA and BSR.  Those keep dispatch priority (the
engine makes the same call), so the autotuner races only the
gather-class products, where measurement can change the choice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from ..ops import spmv as _sp


def _run_csr_rowids(A, operand, op: str):
    fn = _sp.csr_spmv_rowids if op == "spmv" else _sp.csr_spmm_rowids
    return fn(A.data, A.indices, A._rowids_for(operand), operand,
              A.shape[0], lengths=A._get_row_lengths(),
              serial=A._serial_rows(), offsets=A._indptr,
              schedule=A._get_csr_schedule())


def _run_ell(A, operand, op: str):
    ell = A._get_ell()
    if op == "spmv":
        return _sp.ell_spmv(ell[0], ell[1], ell[2], operand)
    return _sp.ell_spmm(ell[0], ell[1], ell[2], operand)


def _run_sliced_ell(A, operand, op: str):
    return _sp.sliced_ell_spmv(A._get_sliced_ell(), operand, A.shape[0])


# Low-precision storage (bf16/f16 values, f32 accumulation): eligible
# only when the matrix already stores narrow values; the race never
# rounds an f32 matrix down to win on bytes.
def _low_precision(A) -> bool:
    return A.dtype in (torch.bfloat16, torch.float16)


def _run_csr_rowids_bf16(A, operand, op: str):
    rid = A._get_row_ids()
    if op == "spmv":
        return _sp.csr_spmv_rowids_f32acc(
            A.data, A.indices, rid, operand, A.shape[0])
    return _sp.csr_spmm_rowids_f32acc(
        A.data, A.indices, rid, operand, A.shape[0])


def _run_ell_bf16(A, operand, op: str):
    ell = A._get_ell()
    return _sp.ell_spmv_f32acc(ell[0], ell[1], ell[2], operand)


def _run_sliced_ell_bf16(A, operand, op: str):
    return _sp.sliced_ell_spmv_f32acc(
        A._get_sliced_ell(), operand, A.shape[0])


# The semiring products over the same three layouts, raced under the
# plus-times pair, where each equals its specialized sibling; the
# verdicts carry over to every semiring dispatch of the structure.
def _run_semiring_csr(A, operand, op: str):
    rid = A._get_row_ids()
    nnz = A.data.shape[0]
    if op == "spmv":
        return _sp.csr_semiring_spmv_rowids_masked(
            A.data, A.indices, rid, nnz, operand, A.shape[0],
            "sum", "times")
    return _sp.csr_semiring_spmm_rowids_masked(
        A.data, A.indices, rid, nnz, operand, A.shape[0],
        "sum", "times")


def _run_semiring_ell(A, operand, op: str):
    ell = A._get_ell()
    if op == "spmv":
        return _sp.ell_semiring_spmv(ell[0], ell[1], ell[2], operand,
                                     "sum", "times")
    return _sp.ell_semiring_spmm(ell[0], ell[1], ell[2], operand,
                                 "sum", "times")


def _run_semiring_sliced_ell(A, operand, op: str):
    return _sp.sliced_ell_semiring_spmv(
        A._get_sliced_ell(), operand, A.shape[0], "sum", "times")


# The delta layer's masked COO product: registered, never raced (its
# buffer is capacity-bounded and rides on a base dispatch the autotuner
# already owns), so ``eligible`` declines every matrix.
def _run_coo_segment(A, operand, op: str):
    rid = A._get_row_ids()
    nnz = A.data.shape[0]
    return _sp.coo_spmv_segment(A.data, rid, A.indices, nnz, operand,
                                A.shape[0])


@dataclass(frozen=True)
class Candidate:
    """One routable kernel family (see module docstring)."""

    label: str
    kernel: str
    ops: Tuple[str, ...]
    eligible: Callable
    run: Callable


CANDIDATES = {
    "csr-rowids": Candidate(
        label="csr-rowids", kernel="csr_spmv_rowids",
        ops=("spmv", "spmm"),
        eligible=lambda A: True,
        run=_run_csr_rowids,
    ),
    "ell": Candidate(
        label="ell", kernel="ell_spmv",
        ops=("spmv", "spmm"),
        eligible=lambda A: A._get_ell() is not None,
        run=_run_ell,
    ),
    "sliced-ell": Candidate(
        label="sliced-ell", kernel="sliced_ell_spmv",
        ops=("spmv",),
        eligible=lambda A: A._get_sliced_ell() is not None,
        run=_run_sliced_ell,
    ),
    "csr-rowids-bf16": Candidate(
        label="csr-rowids-bf16", kernel="csr_spmv_rowids_f32acc",
        ops=("spmv", "spmm"),
        eligible=_low_precision,
        run=_run_csr_rowids_bf16,
    ),
    "ell-bf16": Candidate(
        label="ell-bf16", kernel="ell_spmv_f32acc",
        ops=("spmv",),
        eligible=lambda A: _low_precision(A) and A._get_ell() is not None,
        run=_run_ell_bf16,
    ),
    "sliced-ell-bf16": Candidate(
        label="sliced-ell-bf16", kernel="sliced_ell_spmv_f32acc",
        ops=("spmv",),
        eligible=lambda A: _low_precision(A)
        and A._get_sliced_ell() is not None,
        run=_run_sliced_ell_bf16,
    ),
    "semiring-csr": Candidate(
        label="semiring-csr", kernel="csr_semiring_spmv_rowids_masked",
        ops=("spmv", "spmm"),
        eligible=lambda A: True,
        run=_run_semiring_csr,
    ),
    "semiring-ell": Candidate(
        label="semiring-ell", kernel="ell_semiring_spmv",
        ops=("spmv", "spmm"),
        eligible=lambda A: A._get_ell() is not None,
        run=_run_semiring_ell,
    ),
    "semiring-sliced-ell": Candidate(
        label="semiring-sliced-ell", kernel="sliced_ell_semiring_spmv",
        ops=("spmv",),
        eligible=lambda A: A._get_sliced_ell() is not None,
        run=_run_semiring_sliced_ell,
    ),
    "coo-segment": Candidate(
        label="coo-segment", kernel="coo_spmv_segment",
        ops=("spmv",),
        eligible=lambda A: False,
        run=_run_coo_segment,
    ),
}
