# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Default device, default value type and the runtime singleton.

Mirrors ``legate_sparse_tpu/runtime.py``.  Device policy: entry points
run on ``cuda`` unless the caller names a device (``device="cpu"`` on a
call, or ``set_device("cpu")`` once).  With no CUDA device and no such
request they raise; nothing falls back to the CPU on its own.

``runtime`` (a ``Runtime``) answers the JAX package's questions: how
many devices and processes the job has, and its default mesh, which
covers every rank of a ``torch.distributed`` job and so needs one.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_override: Optional[torch.device] = None


def set_device(device: Union[str, torch.device, None]) -> None:
    """Set the device entry points use when the caller names none;
    ``None`` restores the default (``cuda``)."""
    global _override
    _override = torch.device(device) if device is not None else None


def default_device() -> torch.device:
    if _override is not None:
        return _override
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "legate_sparse_tpu_torch: no CUDA device is available; pass "
        "device='cpu' or call legate_sparse_tpu_torch.runtime."
        "set_device('cpu') to run on the CPU"
    )


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or the default device."""
    if device is None:
        return default_device()
    return torch.device(device)


# Value type of constructors given integer data (scipy parity: CUDA has
# native f64, so there is no reason to narrow).
default_float = torch.float64


class NoProcessGroupError(RuntimeError):
    """A mesh was asked for before ``torch.distributed`` was initialised:
    a port mesh covers every rank of a job, so it needs the job."""


class Runtime:
    """Process-wide device and mesh answers (the JAX package's
    ``Runtime``, reference ``runtime.py:54``)."""

    def __init__(self) -> None:
        self._default_mesh = None

    @property
    def num_devices(self) -> int:
        """The visible CUDA devices, or 1 on the CPU."""
        if _override is not None and _override.type != "cuda":
            return 1
        return torch.cuda.device_count() or 1

    @property
    def num_procs(self) -> int:
        """The job's world size when ``torch.distributed`` is up, else
        ``num_devices``."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return self.num_devices

    @property
    def num_gpus(self) -> int:
        return torch.cuda.device_count()

    @property
    def default_mesh(self):
        """1-D ``("rows",)`` mesh over every rank of the job
        (``parallel.mesh.make_row_mesh``), built at first use; raises
        ``NoProcessGroupError`` when no process group is up."""
        if self._default_mesh is None:
            import torch.distributed as dist

            if not (dist.is_available() and dist.is_initialized()):
                raise NoProcessGroupError(
                    "legate_sparse_tpu_torch: the default mesh covers every "
                    "rank of a torch.distributed job; call "
                    "parallel.mesh.init_distributed() first")
            from .parallel.mesh import make_row_mesh

            self._default_mesh = make_row_mesh()
        return self._default_mesh

    def set_default_mesh(self, mesh) -> None:
        self._default_mesh = mesh

    @property
    def default_float(self) -> torch.dtype:
        return default_float


runtime = Runtime()
