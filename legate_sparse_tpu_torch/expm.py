# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The action of the matrix exponential: ``expm_multiply``.

Mirrors ``legate_sparse_tpu/expm.py``: ``e^{tA} B`` without forming
``e^{tA}``, by scaling and a Taylor chain of fixed degree on the
trace-shifted operator ``A - mu I`` (``_taylor_apply``, ``:50-72``),
with ``s = ceil(norm1 · |t|)`` steps where ``norm1 = ||A||_1 + |mu|``
(``_one_norm``: ``abs(A).sum(axis=0)``).  A Taylor term is one SpMM for
a block ``B`` (the DIA SpMM kernel on a banded matrix) and one SpMV for
a vector, since ``A @ X`` takes an ``(n, 1)`` X as a vector, in both
packages.  The degree is 13 in 32-bit and 20 in 64-bit arithmetic:
the truncation error ``e/(m+1)!`` is then below the working
precision's rounding for a step of norm at most 1.

``LinearOperator`` inputs have no exact 1-norm, so scipy computes them
on the host (``:117-141``).  The JAX package's ``_APPLY_JIT`` and
``_cached_mv`` keep a stable jit identity; there is no compile cache
to feed here, so they have no counterpart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .types import to_numpy_dtype

__all__ = ["expm_multiply"]


def _one_norm(A) -> float:
    """Exact ||A||_1 (max abs column sum) of a sparse matrix or a dense
    tensor."""
    if isinstance(A, torch.Tensor):
        return float(A.abs().sum(dim=0).max())
    return float(abs(A).sum(axis=0).max())


def _taylor_apply(A_mv, B, t: float, mu, s: int, m: int):
    """``F = (e^{t(A - mu I)/s})^s B`` with a degree-``m`` Taylor sum a
    step, ``e^{t mu / s}`` folded back in every step.  Each term is
    ``Bk = (A @ Bk - mu Bk) * (t / (s k))`` with the coefficient
    rounded in the real working precision, ``acc += Bk``, and a step
    ends with ``eta * acc`` in the compute dtype."""
    cdtype = B.dtype
    rdt = cdtype.to_real()
    np_rdt = to_numpy_dtype(rdt)
    t_r, s_r = np_rdt.type(t), np_rdt.type(s)
    coef = [None] + [float(t_r / (s_r * np_rdt.type(k)))
                     for k in range(1, m + 1)]
    eta = torch.exp(torch.as_tensor(t, dtype=rdt, device=B.device) * mu
                    / torch.as_tensor(s, dtype=rdt, device=B.device))
    F = B
    for _ in range(s):
        Bk = acc = F
        for k in range(1, m + 1):
            Bk = (A_mv(Bk) - mu * Bk) * coef[k]
            acc = acc + Bk
        F = (eta * acc).to(cdtype)
    return F


def _host_expm_multiply(A, B, start, stop, num, endpoint, traceA):
    """A ``LinearOperator`` through scipy on the host, re-wrapped as a
    scipy operator (scipy forms ``A - mu I`` from it) with ``traceA``
    0 unless given: the shift only conditions the Taylor scaling."""
    import scipy.sparse.linalg as _ssl

    from .linalg import _solve_device
    from .utils import as_tensor, to_host

    dev = _solve_device(B, getattr(A, "device", None))

    def mv(x):
        return to_host(A.matvec(as_tensor(x, dev, dtype=A.dtype)))

    def rmv(x):
        return to_host(A.rmatvec(as_tensor(x, dev, dtype=A.dtype)))

    try:
        A.rmatvec(torch.zeros(A.shape[0], dtype=A.dtype, device=dev))
    except NotImplementedError:
        rmv = None     # scipy's onenormest reports it
    sp_op = _ssl.LinearOperator(A.shape, dtype=to_numpy_dtype(A.dtype),
                                matvec=mv, rmatvec=rmv)
    out = _ssl.expm_multiply(sp_op, to_host(B), start=start, stop=stop,
                             num=num, endpoint=endpoint,
                             traceA=0.0 if traceA is None else traceA)
    return as_tensor(out, dev)


def expm_multiply(A, B, start=None, stop=None, num=None, endpoint=None,
                  traceA=None):
    """scipy-shaped ``expm_multiply`` (reference ``expm.py:102-217``).

    One point: ``e^A B``.  With ``start``/``stop``/``num``: the stacked
    ``e^{t_k A} B`` over ``np.linspace(start, stop, num,
    endpoint=endpoint)``, each step advanced from the previous one.
    Returns a tensor on ``A``'s device (``B``'s for a dense ``A``)."""
    from .csr import _is_scipy_sparse, csr_array
    from .linalg import LinearOperator, _solve_device
    from .types import to_torch_dtype
    from .utils import as_tensor, is_sparse_matrix

    if isinstance(A, LinearOperator):
        if A.dtype is None:
            raise ValueError("expm_multiply needs an operator with a dtype")
        return _host_expm_multiply(A, B, start, stop, num, endpoint,
                                   traceA)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected A to be like a square matrix")
    if _is_scipy_sparse(A):
        A = csr_array(A)
    sparse_A = is_sparse_matrix(A)
    if not sparse_A and not isinstance(A, torch.Tensor):
        A = as_tensor(A, _solve_device(B, None))
    n = A.shape[0]
    B = as_tensor(B, A.device)
    squeeze = B.dim() == 1
    Bw = B.reshape(n, -1) if squeeze else B

    cdtype = torch.promote_types(to_torch_dtype(A.dtype), Bw.dtype)
    if not (cdtype.is_floating_point or cdtype.is_complex):
        cdtype = torch.promote_types(cdtype, torch.float32)
    Bw = Bw.to(cdtype)
    rdt = cdtype.to_real()
    m = 13 if torch.finfo(rdt).bits == 32 else 20

    trace = A.trace() if sparse_A else torch.trace(A)
    mu_c = (complex(trace) if traceA is None else complex(traceA)) / n
    mu = torch.as_tensor(mu_c if cdtype.is_complex else mu_c.real,
                         dtype=cdtype, device=A.device)
    norm1 = _one_norm(A) + abs(mu_c)   # the shift moves the norm by <= |mu|

    Ad = A if sparse_A else A.to(cdtype)

    def A_mv(X):
        return (Ad @ X).to(cdtype)

    def advance(F, dt: float):
        if dt == 0.0:
            return F
        # A = mu I (or A = 0) needs no special case: the shifted product
        # is 0, the Taylor sum collapses to F and eta gives e^{dt mu}.
        s = max(1, int(math.ceil(norm1 * abs(dt))))
        return _taylor_apply(A_mv, F, dt, mu, s, m)

    if start is None and stop is None and num is None:
        out = advance(Bw, 1.0)
        return out[:, 0] if squeeze else out

    if num is None:
        num = 50                       # scipy's default
    if endpoint is None:
        endpoint = True
    ts = np.linspace(float(start), float(stop), int(num), endpoint=endpoint)
    F = advance(Bw, float(ts[0]))
    outs = [F]
    for k in range(1, len(ts)):
        F = advance(F, float(ts[k] - ts[k - 1]))
        outs.append(F)
    stacked = torch.stack(outs, dim=0)
    return stacked[:, :, 0] if squeeze else stacked
