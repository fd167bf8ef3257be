# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Environment-driven settings.

Mirrors the SpMV-dispatch knobs of ``legate_sparse_tpu/settings.py``
(``Settings.__init__``), under the same environment names and
defaults, so one environment configures both packages alike.  Each is
read once at import and can be overridden by assignment.

``dia_max_expand`` (``LEGATE_SPARSE_TPU_DIA_EXPAND``, 2.0)
    A CSR matrix is taken as banded when its distinct diagonals number
    at most ``dia_max_expand * nnz / cols`` (and ``dia_max_diags``).
    0 disables band detection.
``dia_max_diags`` (``LEGATE_SPARSE_TPU_DIA_MAX_DIAGS``, 128)
    Most diagonals a band may have; also the DIA kernel's limit.
``ell_max_expand`` (``LEGATE_SPARSE_TPU_ELL_EXPAND``, 4.0)
    ELL packing when ``rows * max_row_nnz <= ell_max_expand * nnz``.
``bsr_max_expand`` (``LEGATE_SPARSE_TPU_BSR_EXPAND``, 128.0)
    BSR structure when the densified present blocks hold at most this
    multiple of nnz.  0 disables BSR.
``bsr_force`` (``LEGATE_SPARSE_TPU_BSR_FORCE``, off)
    Build the BSR structure on any device (on the CPU its wrapper runs
    the plain version) — the differential-testing hook.
``spgemm_chunk_products`` (``LEGATE_SPARSE_SPGEMM_CHUNK``, 2^24)
    Most products per ESC expansion chunk: a product that expands more
    runs in chunks, so peak memory is O(chunk + nnz(C)) instead of
    O(T).  The JAX package's ``LEGATE_SPARSE_FAST_SPGEMM`` (one pass,
    whatever T) has no counterpart: a chunk of at least T is one pass.
"""

from __future__ import annotations

import os


def _env_bool(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.lower() not in ("0", "false", "no", "off", "")


class Settings:
    def __init__(self) -> None:
        self.ell_max_expand: float = float(
            os.environ.get("LEGATE_SPARSE_TPU_ELL_EXPAND", "4.0"))
        self.dia_max_expand: float = float(
            os.environ.get("LEGATE_SPARSE_TPU_DIA_EXPAND", "2.0"))
        self.dia_max_diags: int = int(
            os.environ.get("LEGATE_SPARSE_TPU_DIA_MAX_DIAGS", "128"))
        self.bsr_max_expand: float = float(
            os.environ.get("LEGATE_SPARSE_TPU_BSR_EXPAND", "128.0"))
        self.bsr_force: bool = _env_bool("LEGATE_SPARSE_TPU_BSR_FORCE",
                                         False)
        self.spgemm_chunk_products: int = int(
            os.environ.get("LEGATE_SPARSE_SPGEMM_CHUNK", 1 << 24))


settings = Settings()
