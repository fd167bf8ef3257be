# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``../csrc`` compiles on its own into a shared library
with a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 -shared -Xcompiler -fPIC``), named by a hash of the
source and the flags, under ``build/torch_kernels/`` at the root of the
checkout (``LEGATE_SPARSE_TPU_TORCH_BUILD_DIR`` overrides it).  A
library is built at its first use and reused while its source is
unchanged.  ``build_all`` starts one nvcc per source at once.  A failed
build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"dia_spmv": "dia_spmv.cu", "bsr_spmv": "bsr_spmv.cu",
           "dia_spmm": "dia_spmm.cu", "bsr_spmm": "bsr_spmm.cu",
           "dia_spgemm": "dia_spgemm.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# nvcc's output of the last build of each library (registers, spills).
LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("LEGATE_SPARSE_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return build_dir() / f"lib{name}_{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Build every named library that is missing, all nvcc processes at
    once; raise with nvcc's stderr on the first that fails."""
    names = list(SOURCES if names is None else names)
    started = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started.append((name, proc, tmp, so, cmd))
    failures = []
    for name, proc, tmp, so, cmd in started:
        out, err = proc.communicate()
        LOGS[name] = out + err
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name} (exit "
                            f"{proc.returncode}): {' '.join(cmd)}\n{err}")
        else:
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
