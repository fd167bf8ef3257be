# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The scipy.sparse namespace: native names wrapped, the rest from scipy.

Mirrors ``legate_sparse_tpu/coverage.py``: ``wrap`` (a profiler scope
around a native callable: ``torch.profiler.record_function`` where the
JAX package opens a ``jax.named_scope``), ``scipy_fallback`` (scipy on
the host, with this package's arrays and tensors converted at the
boundary), ``clone_module`` and ``clone_scipy_arr_kind``.

A fallback's sparse result comes back as this package's array of the
same format (CSR, CSC, COO or DIA; others as CSR), and a dense one as a
tensor, on the device of its first sparse-matrix or tensor argument,
else on the default device.  The fallbacks are the documented host
escape for names this package has no code of its own for, and for the
cases its native functions hand to scipy (``eigen.py``'s and
``csgraph.py``'s host escapes, as in the JAX package).
"""

from __future__ import annotations

import functools
import types as pytypes
from typing import Any, Mapping

import numpy as np
import torch

MOD_INTERNAL = {"__dir__", "__getattr__"}


def wrap(func, name: str | None = None):
    """``func`` inside a profiler scope named after it (reference
    ``coverage.py:27-38``)."""
    scope = ("legate_sparse_tpu_torch."
             f"{name or getattr(func, '__qualname__', 'op')}")

    @functools.wraps(func)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        with torch.profiler.record_function(scope):
            return func(*args, **kwargs)

    return wrapper


def _to_scipy(x):
    """This package's sparse arrays as scipy's, tensors as numpy arrays,
    inside lists and tuples too; anything else as it is."""
    from .utils import is_sparse_matrix, to_numpy

    if is_sparse_matrix(x):
        return x.toscipy()
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    if isinstance(x, (list, tuple)):
        converted = [_to_scipy(v) for v in x]
        return type(x)(converted) if isinstance(x, tuple) else converted
    return x


def _input_device(args) -> torch.device | None:
    from .utils import is_sparse_matrix

    for a in args:
        if is_sparse_matrix(a) or isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (list, tuple)):
            dev = _input_device(a)
            if dev is not None:
                return dev
    return None


def _from_scipy(x, device: torch.device):
    """scipy sparse results as this package's arrays on ``device``
    (the format kept for CSR, CSC, COO and DIA), numeric numpy arrays as
    tensors there, inside tuples too; anything else as it is."""
    import scipy.sparse as _sp

    from .utils import as_tensor

    if _sp.issparse(x):
        from .coo import coo_array
        from .csc import csc_array
        from .csr import csr_array
        from .dia import dia_array

        fmt = getattr(x, "format", "csr")
        if fmt == "dia":
            return dia_array((x.data, x.offsets), shape=x.shape,
                             device=device)
        ctor = {"csc": csc_array, "coo": coo_array}.get(fmt, csr_array)
        return ctor(x if fmt in ("csr", "csc", "coo") else x.tocsr(),
                    device=device)
    if isinstance(x, np.ndarray) and x.dtype.kind in "biufc":
        return as_tensor(x, device)
    if isinstance(x, tuple):
        return tuple(_from_scipy(v, device) for v in x)
    return x


def scipy_fallback(func, name: str):
    """``func`` (a scipy function) adapted to this package: sparse
    arrays and tensors convert to scipy and numpy on the way in, and
    results convert back on the way out (``_from_scipy``).  A
    documented escape to the host: the operands cross it both ways.
    Each call counts ``scipy_fallback.<name>`` and, while tracing is
    on, records a ``scipy_fallback`` span (reference
    ``coverage.py:94-99``)."""
    scope = f"legate_sparse_tpu_torch.{name}"

    @functools.wraps(func)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        from . import obs as _obs
        from .runtime import resolve_device

        _obs.inc("scipy_fallback." + name)
        device = _input_device(list(args) + list(kwargs.values()))
        args = tuple(_to_scipy(a) for a in args)
        kwargs = {k: _to_scipy(v) for k, v in kwargs.items()}
        with torch.profiler.record_function(scope), \
                _obs.span("scipy_fallback", func=name):
            result = func(*args, **kwargs)
        return _from_scipy(result, device if device is not None
                           else resolve_device(None))

    wrapper._lst_scipy_fallback = True
    return wrapper


def clone_module(origin_module: pytypes.ModuleType,
                 new_globals: Mapping[str, Any]) -> None:
    """Fill the public names of ``origin_module`` (scipy.sparse) into
    ``new_globals`` (reference ``coverage.py:106-134``): a name the
    caller defines stays native (a callable wrapped by ``wrap``), any
    other callable becomes its ``scipy_fallback``, and other values
    are copied."""
    mod_names = set(new_globals.keys())
    for attr in dir(origin_module):
        if attr.startswith("_") or attr in MOD_INTERNAL:
            continue
        value = getattr(origin_module, attr)
        if attr in mod_names:
            native = new_globals[attr]
            if callable(native) and not isinstance(native, type):
                new_globals[attr] = wrap(native, attr)  # type: ignore[index]
            continue
        if callable(value) and not isinstance(value, type):
            new_globals[attr] = scipy_fallback(value, attr)  # type: ignore[index]
        else:
            new_globals[attr] = value  # type: ignore[index]


def clone_scipy_arr_kind(origin_class):
    """Class decorator stamping scipy's class as the facade's origin
    (reference ``coverage.py:137-146``); the methods stay native."""

    def decorator(cls):
        cls.__doc__ = cls.__doc__ or origin_class.__doc__
        cls._scipy_origin = origin_class
        return cls

    return decorator
