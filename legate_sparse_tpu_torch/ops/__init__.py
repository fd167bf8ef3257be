# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Kernels and plain tensor ops (mirrors ``legate_sparse_tpu/ops``).

``dia_kernel`` and ``bsr`` each hold a hand-written CUDA kernel
(sources in ``../csrc``, built by ``_build``) beside its plain PyTorch
version; ``convert``, ``spmv`` and ``dia_ops`` are plain PyTorch.
"""
