# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The harness the port's apps share: the port of ``examples/common.py``.

- ``parse_common_args`` reads ``--package torch|scipy`` (the port on a
  torch device, or host scipy as the differential baseline),
  ``--device`` (torch's; default ``cuda``), ``--dtype`` (default
  ``harness_float``: float32 on ``cuda``, so the hand-written kernels
  run; float64 on the CPU) and ``--profile DIR``, and returns a
  ``Harness``:
  the package's ``sparse`` and ``linalg`` modules, its timer, the
  device, and the dtype of the generators.
- ``TorchTimer`` fences with ``torch.cuda.synchronize()`` at both ends
  on ``cuda`` (the CPU's ops have finished when they return), so a
  timed region holds the device work it launched; ``NumPyTimer`` is the
  host clock of the scipy baseline.
- The generators (``banded_matrix``, ``stencil_grid``, ``poisson2D``,
  ``diffusion2D``) build with vectorised numpy and hand the arrays to
  the package named by ``package``, so both packages (and the JAX
  package's examples) get the same entries.
- ``--profile DIR`` runs the app under ``torch.profiler`` and writes a
  Chrome trace into DIR when it ends.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import NamedTuple, Optional

import numpy
import torch

PACKAGES = ("torch", "scipy")


def harness_float(package: str = "torch", device=None):
    """Value dtype of the generators, following the platform as the JAX
    harness does: float32 on ``cuda`` (the hand-written kernels take f32
    and bf16; a float64 matrix runs their plain PyTorch twins), the
    port's default float (``runtime.default_float``, float64) on the
    CPU, numpy's float64 for the scipy baseline."""
    if package == "scipy":
        return numpy.float64
    from ..runtime import default_float, resolve_device

    if resolve_device(device).type == "cuda":
        return torch.float32
    return default_float


def get_arg_number(arg: str) -> int:
    """Parse '4k' / '2m' / '1g' style sizes (powers of 1024)."""
    arg = arg.lower()
    if not arg:
        return 1
    mult = 1
    if arg[-1] == "k":
        mult, arg = 1024, arg[:-1]
    elif arg[-1] == "m":
        mult, arg = 1024 * 1024, arg[:-1]
    elif arg[-1] == "g":
        mult, arg = 1024 * 1024 * 1024, arg[:-1]
    return int(arg) * mult


class TorchTimer:
    """Wall clock of a region with the device fenced at both ends:
    ``torch.cuda.synchronize()`` on ``cuda``, nothing on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._start = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        # Drain the work already launched so it is not charged here.
        self._sync()
        self._start = time.perf_counter_ns()

    def stop(self, result=None):
        """Milliseconds since ``start()``, after the device finished
        everything launched since (``result`` is accepted for the
        examples' signature; the fence covers it)."""
        self._sync()
        return (time.perf_counter_ns() - self._start) / 1e6


class NumPyTimer:
    def __init__(self):
        self._start = None

    def start(self):
        self._start = time.perf_counter_ns()

    def stop(self, result=None):
        return (time.perf_counter_ns() - self._start) / 1e6


class Harness(NamedTuple):
    package: str                   # "torch" or "scipy"
    timer: object
    sparse: object                 # legate_sparse_tpu_torch or scipy.sparse
    linalg: object
    device: Optional[torch.device]  # None for scipy
    dtype: object                  # the generators' value dtype
    profile: Optional[str]

    def profiling(self):
        """Context manager: ``torch.profiler`` around the body when
        ``--profile DIR`` was given (its Chrome trace into DIR), else
        nothing."""
        if not self.profile:
            return contextlib.nullcontext()
        return _profiled(self.profile, self.device)


@contextlib.contextmanager
def _profiled(out_dir: str, device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(out_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"profiling -> {path} (view with Perfetto or chrome://tracing)")


def parse_common_args(argv=None) -> Harness:
    """Read the harness options from ``argv`` (default ``sys.argv``;
    other options are left to the app)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--package", default="torch", choices=PACKAGES,
                        help="'torch' = the port; 'scipy' = host baseline")
    parser.add_argument("--device", default=None,
                        help="torch device of the port (default: cuda)")
    parser.add_argument("--dtype", default=None,
                        choices=["float32", "float64"],
                        help="value dtype of the generated matrices "
                        "(default: harness_float: float32 on cuda, "
                        "float64 on the CPU)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of the "
                        "run into DIR")
    args, _ = parser.parse_known_args(argv)
    if args.package == "scipy":
        import scipy.sparse
        import scipy.sparse.linalg

        if args.profile:
            print("--profile ignored for --package scipy")
        return Harness("scipy", NumPyTimer(), scipy.sparse,
                       scipy.sparse.linalg, None,
                       numpy.dtype(args.dtype or numpy.float64), None)
    import legate_sparse_tpu_torch
    from .. import linalg
    from ..runtime import resolve_device
    from ..types import to_torch_dtype

    device = resolve_device(args.device)
    dtype = (to_torch_dtype(args.dtype) if args.dtype
             else harness_float("torch", device))
    return Harness("torch", TorchTimer(device), legate_sparse_tpu_torch,
                   linalg, device, dtype, args.profile)


def _ctors(package: str, device):
    """(csr_array, diags, dia_array) of ``package``; the port's are
    bound to ``device``."""
    if package == "scipy":
        import scipy.sparse as sp

        return sp.csr_array, sp.diags, sp.dia_array
    import functools

    from .. import csr_array, diags
    from ..dia import dia_array

    return (functools.partial(csr_array, device=device),
            functools.partial(diags, device=device),
            functools.partial(dia_array, device=device))


def banded_matrix(N: int, nnz_per_row: int, from_diags: bool = False,
                  package: str = "torch", device=None, dtype=None):
    """Banded CSR with 1.0 values: ``nnz_per_row`` (odd) diagonals
    centred on the main one.  ``from_diags`` builds it through
    ``diags(...)``, else (data, indices, indptr) with vectorised numpy."""
    csr_array, diags, _ = _ctors(package, device)
    dtype = harness_float(package, device) if dtype is None else dtype
    if from_diags:
        return diags([1.0] * nnz_per_row,
                     [d - nnz_per_row // 2 for d in range(nnz_per_row)],
                     shape=(N, N), format="csr", dtype=dtype)
    if not (N > nnz_per_row and nnz_per_row % 2 == 1):
        raise ValueError(f"banded_matrix needs N > nnz_per_row and an odd "
                         f"nnz_per_row, got N={N}, {nnz_per_row}")
    half = nnz_per_row // 2
    cols = numpy.tile(numpy.arange(-half, nnz_per_row - half), N) \
        + numpy.repeat(numpy.arange(N), nnz_per_row)
    mask = (cols >= 0) & (cols < N)
    cols = cols[mask]
    counts = mask.reshape(N, nnz_per_row).sum(axis=1)
    indptr = numpy.zeros(N + 1, dtype=numpy.int64)
    numpy.cumsum(counts, out=indptr[1:])
    return csr_array((numpy.ones(cols.shape[0]), cols.astype(numpy.int64),
                      indptr), shape=(N, N), dtype=dtype)


def stencil_grid(S, grid, dtype=None, package: str = "torch", device=None):
    """CSR operator applying stencil ``S`` over an N-D ``grid`` with zero
    (Dirichlet) boundaries: one DIA band per nonzero stencil entry,
    connections across the boundary zeroed by index arithmetic."""
    _, _, dia_array = _ctors(package, device)
    dtype = harness_float(package, device) if dtype is None else dtype
    np_dtype = dtype
    if package == "torch":
        from ..types import to_numpy_dtype, to_torch_dtype

        np_dtype = to_numpy_dtype(to_torch_dtype(dtype))
    S = numpy.asarray(S, dtype=np_dtype)
    grid = tuple(int(g) for g in grid)
    N_v = int(numpy.prod(grid))
    strides = numpy.cumprod([1] + list(reversed(grid)))[:-1][::-1]

    offsets = []
    bands = []
    centered = [idx - (s // 2) for idx, s in zip(numpy.nonzero(S), S.shape)]
    coords_nd = numpy.unravel_index(numpy.arange(N_v), grid)
    for entry in range(centered[0].shape[0]):
        off_nd = [int(c[entry]) for c in centered]
        diag = int(sum(o * st for o, st in zip(off_nd, strides)))
        if abs(diag) >= N_v:
            continue
        val = S[tuple(idx[entry] for idx in numpy.nonzero(S))]
        band = numpy.full(N_v, val, dtype=np_dtype)
        # Position p connects to p+diag only if every coordinate stays in
        # range after the per-axis offset.
        ok = numpy.ones(N_v, dtype=bool)
        for axis, o in enumerate(off_nd):
            c = coords_nd[axis]
            ok &= (c + o >= 0) & (c + o < grid[axis])
        band[~ok] = 0.0
        # DIA convention: the band value for column j lives at band[j].
        shifted = numpy.zeros(N_v, dtype=np_dtype)
        src = numpy.arange(N_v)
        dst = src + diag
        sel = (dst >= 0) & (dst < N_v)
        shifted[dst[sel]] = band[src[sel]]
        offsets.append(diag)
        bands.append(shifted)

    offsets_a = numpy.array(offsets)
    order = numpy.argsort(offsets_a)
    uniq, inv = numpy.unique(offsets_a[order], return_inverse=True)
    data = numpy.zeros((uniq.shape[0], N_v), dtype=np_dtype)
    for k, band in enumerate(numpy.asarray(bands)[order]):
        data[inv[k]] += band
    return dia_array((data, uniq), shape=(N_v, N_v)).tocsr()


def poisson2D(N: int, package: str = "torch", device=None, dtype=None):
    """5-point 2-D Poisson operator on N*N unknowns, as CSR (the zero
    couplings across grid rows are dropped)."""
    _, diags, _ = _ctors(package, device)
    first = numpy.full(N - 1, -1.0)
    chunks = numpy.concatenate([numpy.zeros(1), first])
    diag_size = N * N - 1
    diag_a = numpy.concatenate(
        [first, numpy.tile(chunks, (diag_size - (N - 1)) // N)])
    diag_g = -1.0 * numpy.ones(N * (N - 1))
    diag_c = 4.0 * numpy.ones(N * N)
    return diags([diag_g, diag_a, diag_c, diag_a, diag_g], [-N, -1, 0, 1, N],
                 dtype=harness_float(package, device) if dtype is None
                 else dtype).tocsr()


def diffusion2D(N: int, epsilon: float = 1.0, theta: float = 0.0,
                package: str = "torch", device=None, dtype=None):
    """9-point rotated-anisotropy diffusion operator on N*N unknowns."""
    eps = float(epsilon)
    C = numpy.cos(float(theta))
    S = numpy.sin(float(theta))
    CS, CC, SS = C * S, C * C, S * S
    a = (-1 * eps - 1) * CC + (-1 * eps - 1) * SS + (3 * eps - 3) * CS
    b = (2 * eps - 4) * CC + (-4 * eps + 2) * SS
    c = (-1 * eps - 1) * CC + (-1 * eps - 1) * SS + (-3 * eps + 3) * CS
    d = (-4 * eps + 2) * CC + (2 * eps - 4) * SS
    e = (8 * eps + 8) * CC + (8 * eps + 8) * SS
    stencil = numpy.array([[a, b, c], [d, e, d], [c, b, a]]) / 6.0
    return stencil_grid(stencil, (N, N), dtype=dtype, package=package,
                        device=device)
