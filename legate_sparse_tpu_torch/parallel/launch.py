# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Run a function on N ranks of a fresh process group, each in its own
spawned process, and collect what each returns.

The JAX package needs no launcher: its distributed code is one
program over a mesh of devices.  Here each shard is a process, and a
caller that holds no job of its own (a test, ``chip_smoke.py``, a
one-card run) starts one with ``run_ranks``:

- the ranks are started with ``spawn``, never ``fork`` (the caller may
  hold CUDA state or threads a fork would copy);
- they meet at a ``FileStore`` in a fresh temporary directory, so no
  port is opened and two launches never collide;
- ``init_process_group`` gets a ``timeout``, and the launch a wall-clock
  limit: a rank that has not returned by then is killed, every other
  rank with it, and ``run_ranks`` raises ``TimeoutError``;
- each rank leaves the group (``destroy_process_group``) on every exit
  path, and asserts that it imported neither ``jax`` nor the JAX
  package (the port and its ranks run without them).

``fn(rank, world_size, *args)`` must be importable by name (a
module-level function) and return something picklable; ``run_ranks``
returns the ranks' results in rank order.  A rank that raises makes
``run_ranks`` raise ``RuntimeError`` with that rank's traceback, after
the other ranks are stopped.
"""

from __future__ import annotations

import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

_FORBIDDEN = ("jax", "legate_sparse_tpu")


def _no_jax(where: str) -> None:
    held = [m for m in _FORBIDDEN if m in sys.modules]
    if held:
        raise RuntimeError(f"rank {where}: imported {held}; the port's "
                           "ranks run without JAX")


def _rank_main(fn, rank: int, world_size: int, backend: str, store: str,
               init_timeout: float, threads: Optional[int], args, out):
    import torch
    import torch.distributed as dist

    from .mesh import init_distributed

    try:
        _no_jax(f"{rank} at start")
        if threads is not None:
            torch.set_num_threads(threads)
        init_distributed(backend=backend, init_method=f"file://{store}",
                         world_size=world_size, rank=rank,
                         timeout=init_timeout)
        result = fn(rank, world_size, *args)
        _no_jax(f"{rank} at end")
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *,
              backend: Optional[str] = None,
              args: tuple = (), timeout: float = 120.0,
              init_timeout: float = 60.0,
              threads: Optional[int] = None) -> List[Any]:
    """``[fn(r, world_size, *args) for r in ranks]``, each in a spawned
    rank of a ``backend`` process group; ``timeout`` seconds for the
    whole launch, ``init_timeout`` for the group's collectives;
    ``threads`` sets ``torch.set_num_threads`` in each rank.  With no
    ``backend``, NCCL on ``cuda`` (``mesh.default_backend``): without
    a CUDA device it raises before any rank starts, unless the caller
    asked for the CPU (``backend="gloo"``)."""
    import multiprocessing as mp

    from .mesh import default_backend

    if backend is None:
        backend = default_backend()

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="lst-ranks-")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, r, world_size, backend,
                               os.path.join(tmp, "store"), init_timeout,
                               threads, args, out))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout
    results, failure = {}, None
    try:
        for p in procs:
            p.start()
        while len(results) < world_size and failure is None:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = out.get(timeout=max(min(left, 1.0), 0.01))
            except queue.Empty:
                if left <= 0:
                    raise TimeoutError(
                        f"run_ranks: {world_size - len(results)} of "
                        f"{world_size} ranks did not return within "
                        f"{timeout} s") from None
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    # A rank that raised wrote its traceback first.
                    try:
                        rank, ok, value = out.get(timeout=1.0)
                    except queue.Empty:
                        failure = (f"rank process {dead[0].name} exited "
                                   f"with code {dead[0].exitcode}")
                        continue
                else:
                    continue
            if ok:
                results[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
        if failure is not None:
            raise RuntimeError(f"run_ranks: {failure}")
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [results[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
