# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""legate_sparse_tpu_torch.engine: shape-bucketed plans, the
micro-batching request executor and the multi-tenant gateway (the port
of ``legate_sparse_tpu/engine``).

- **plan cache** (``plan_cache``): bucketed eager plans keyed on (op,
  dtype, shape *bucket*, mesh fingerprint, settings epoch), with an
  explicit ``warmup(plans)``;
- **shape bucketing** (``buckets``): power-of-two (or ladder) padding
  with masked tails, bit for bit the unpadded products;
- **request executor** (``executor``): thread-safe ``submit`` that
  stacks same-matrix SpMV requests into one SpMM dispatch;
- **admission gateway** (``gateway``, ``LEGATE_SPARSE_TPU_GATEWAY``):
  QoS classes, per-tenant token buckets and queue quotas, weighted fair
  queueing, cross-matrix packing into one ``multi_matvec`` dispatch,
  deadline-aware dispatch and typed shedding.

Enable with ``LEGATE_SPARSE_TPU_ENGINE=1`` (or ``settings.engine =
True``): eligible ``csr_array.dot`` products and solver matvecs then
route through the engine.  Its activity lands in the ``engine.*`` obs
counters and spans.
"""

from .buckets import bucket, k_bucket, next_pow2  # noqa: F401
from .core import (  # noqa: F401
    Engine, engine_enabled, get_engine, reset_engine, route_matmat,
    route_matvec, warmup,
)
from .executor import RequestExecutor  # noqa: F401
from .gateway import (  # noqa: F401
    QOS_CLASSES, QOS_WEIGHTS, Gateway, get_gateway, reset_gateway,
)
from .plan_cache import Plan, PlanCache, PlanKey  # noqa: F401

__all__ = [
    "bucket", "k_bucket", "next_pow2",
    "Engine", "engine_enabled", "get_engine", "reset_engine",
    "route_matvec", "route_matmat", "warmup",
    "RequestExecutor",
    "QOS_CLASSES", "QOS_WEIGHTS", "Gateway", "get_gateway",
    "reset_gateway",
    "Plan", "PlanCache", "PlanKey",
]
