# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Default device and default value type.

Mirrors the part of ``legate_sparse_tpu/runtime.py`` that this port
needs.  Device policy: entry points run on ``cuda`` unless the caller
names a device (``device="cpu"`` on a call, or ``set_device("cpu")``
once).  With no CUDA device and no such request they raise; nothing
falls back to the CPU on its own.
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
