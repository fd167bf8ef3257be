# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""ctypes loader for the native Matrix Market parser.

Mirrors the parser half of ``legate_sparse_tpu/utils_native.py``
(``:25-80``, ``native_mtx_read``): ``lst_mtx_read`` and ``lst_free``
of ``src/mtx_reader.cc``, the repository's C++ host parser, loaded
through ``ctypes``.  The library is optional: ``io.mmread`` uses the
numpy parser without it.  It is built by the host C++ compiler
(``$CXX``, else ``g++``) into the repository's ``build/native/`` —
the JAX package's build goes to ``src/build/`` — by ``build()``, or
on first use when ``LEGATE_SPARSE_TPU_BUILD_NATIVE=1`` (the JAX
package's opt-in: building at import would surprise a read-only
deployment).

The JAX package's ``native_bsr_pack`` and ``native_coo_to_csr`` have
no counterpart: the port builds its BSR structure and its CSR on the
matrix's device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "src", "mtx_reader.cc")
LIBRARY = os.path.join(_ROOT, "build", "native", "liblst_mtx_reader.so")

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def build() -> str:
    """Compile ``src/mtx_reader.cc`` into ``LIBRARY`` (written to a
    temporary name, then renamed, so concurrent builds cannot leave a
    torn file) and return its path; a failed compile raises
    ``RuntimeError`` with the compiler's output."""
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(LIBRARY))
    os.close(fd)
    try:
        res = subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC",
             "-shared", "-o", tmp, SOURCE],
            capture_output=True, text=True, timeout=300, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"native parser build failed (rc "
                               f"{res.returncode}): {res.stderr[-2000:]}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIBRARY


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if (not os.path.exists(LIBRARY)
            and os.environ.get("LEGATE_SPARSE_TPU_BUILD_NATIVE", "0") == "1"):
        try:
            build()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            sys.stderr.write(f"legate_sparse_tpu_torch: {e}; using the "
                             "numpy parser\n")
    if os.path.exists(LIBRARY):
        try:
            lib = ctypes.CDLL(LIBRARY)
            _bind(lib)
            _LIB = lib
        except (OSError, AttributeError):
            _LIB = None      # unloadable or stale: the numpy parser
    return _LIB


def reload() -> bool:
    """Forget the load attempt (after ``build()``) and load again;
    True when the library is loaded."""
    global _LIB, _LIB_TRIED
    _LIB, _LIB_TRIED = None, False
    return _load() is not None


def _bind(lib: ctypes.CDLL) -> None:
    lib.lst_mtx_read.restype = ctypes.c_int
    lib.lst_mtx_read.argtypes = [
        ctypes.c_char_p,                                  # path
        ctypes.POINTER(ctypes.c_int64),                   # out m
        ctypes.POINTER(ctypes.c_int64),                   # out n
        ctypes.POINTER(ctypes.c_int64),                   # out nnz
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),   # rows
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),   # cols
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),  # vals
    ]
    lib.lst_free.restype = None
    lib.lst_free.argtypes = [ctypes.c_void_p]


def native_mtx_read(path: str) -> Optional[
        Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]]:
    """``(m, n, rows, cols, vals)`` of a Matrix Market coordinate file
    (0-based int64 coordinates, float64 values, symmetric entries
    mirrored), or None when the library is not loaded or rejects the
    file."""
    lib = _load()
    if lib is None:
        return None
    m = ctypes.c_int64()
    n = ctypes.c_int64()
    nnz = ctypes.c_int64()
    rows_p = ctypes.POINTER(ctypes.c_int64)()
    cols_p = ctypes.POINTER(ctypes.c_int64)()
    vals_p = ctypes.POINTER(ctypes.c_double)()
    rc = lib.lst_mtx_read(
        os.fsencode(path), ctypes.byref(m), ctypes.byref(n),
        ctypes.byref(nnz), ctypes.byref(rows_p), ctypes.byref(cols_p),
        ctypes.byref(vals_p))
    if rc != 0:
        return None
    count = nnz.value
    try:
        if count == 0:
            empty = np.zeros(0, dtype=np.int64)
            return (m.value, n.value, empty, empty.copy(),
                    np.zeros(0, dtype=np.float64))
        rows = np.ctypeslib.as_array(rows_p, shape=(count,)).copy()
        cols = np.ctypeslib.as_array(cols_p, shape=(count,)).copy()
        vals = np.ctypeslib.as_array(vals_p, shape=(count,)).copy()
    finally:
        lib.lst_free(rows_p)
        lib.lst_free(cols_p)
        lib.lst_free(vals_p)
    return m.value, n.value, rows, cols, vals
