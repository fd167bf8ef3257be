# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Kernels and plain tensor ops (mirrors ``legate_sparse_tpu/ops``).

``dia_kernel`` and ``bsr`` each hold a hand-written CUDA kernel
(sources in ``../csrc``, built by ``_build``) beside its plain PyTorch
version; ``convert``, ``spmv`` and ``dia_ops`` are plain PyTorch.
"""


def kernel_wrappers() -> dict:
    """The five hand-written kernels' wrappers by kernel name; each
    wrapper's ``launches`` counts its kernel's CUDA launches in this
    process (a CPU tensor takes the plain version and counts none)."""
    from . import bsr, dia_kernel

    return {"dia_spmv": dia_kernel.dia_spmv, "bsr_spmv": bsr.bsr_spmv,
            "dia_spmm": dia_kernel.dia_spmm, "bsr_spmm": bsr.bsr_spmm,
            "dia_spgemm": dia_kernel.dia_spgemm}
