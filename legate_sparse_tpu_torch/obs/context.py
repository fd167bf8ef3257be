# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Request-scoped trace ids (the port of ``legate_sparse_tpu/obs/context.py``).

A :class:`TraceContext` (trace id, request id, tenant, QoS class) is
minted at ``Gateway.submit`` and ``RequestExecutor.submit``, carried
across worker threads on the request record itself (contextvars do not
follow a request into the thread that dispatches it), and activated
around each dispatch body by :func:`use`.  While one is active,
``obs.trace`` tags every span and event closed on that thread with its
``trace_id``, and the Chrome trace binds the tagged slices of one
request into a flow arc.

Minting is one ``next()`` on a shared counter and one small object;
activation is one contextvar set and reset.  Nothing here takes the
trace lock.

``profiler_scope(op)`` opens ``torch.profiler.record_function`` named
``<op>[<trace-id>]`` while a context is active (where the JAX package
opens a ``jax.profiler.TraceAnnotation``), so a ``torch.profiler``
capture joins obs spans to its rows by trace id.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
from typing import Iterator, Optional

__all__ = ["TraceContext", "mint", "current_trace_id", "use",
           "profiler_scope"]

# ``next()`` on an itertools.count is atomic under the GIL.
_IDS = itertools.count(1)

_var: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("legate_sparse_tpu_torch_trace_ctx", default=None)


class TraceContext:
    """Immutable identity of one request: ``trace_id`` (the flow key,
    unique in the process), the request id ``rid`` when known, and the
    admission identity ``tenant``/``qos``."""

    __slots__ = ("trace_id", "rid", "tenant", "qos")

    def __init__(self, trace_id: str, rid: Optional[int] = None,
                 tenant: Optional[str] = None,
                 qos: Optional[str] = None):
        object.__setattr__(self, "trace_id", trace_id)
        object.__setattr__(self, "rid", rid)
        object.__setattr__(self, "tenant", tenant)
        object.__setattr__(self, "qos", qos)

    def __setattr__(self, name, value):
        raise AttributeError("TraceContext is immutable")

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id!r}, rid={self.rid!r}, "
                f"tenant={self.tenant!r}, qos={self.qos!r})")


def mint(rid: Optional[int] = None, kind: str = "req",
         tenant: Optional[str] = None,
         qos: Optional[str] = None) -> TraceContext:
    """A new context, or the one already active on this thread: a
    nested submit joins the outermost request's arc."""
    cur = _var.get()
    if cur is not None:
        return cur
    return TraceContext(f"{kind}-{next(_IDS):06d}", rid, tenant, qos)


def current_trace_id() -> Optional[str]:
    """The active trace id, or None."""
    ctx = _var.get()
    return None if ctx is None else ctx.trace_id


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Activate ``ctx`` for the body (None: no-op)."""
    if ctx is None:
        yield None
        return
    token = _var.set(ctx)
    try:
        yield ctx
    finally:
        _var.reset(token)


def profiler_scope(op: str):
    """``torch.profiler.record_function("<op>[<trace-id>]")`` while a
    context is active, else a null context.  It annotates the profiler's
    host timeline and launches nothing."""
    ctx = _var.get()
    if ctx is None:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(f"{op}[{ctx.trace_id}]")
