# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Applications written against the port, the ports of ``examples/``:
``common`` (the shared harness and matrix generators), ``pde``, ``gmg``,
``spmv_microbenchmark``, ``spgemm_microbenchmark`` and ``spectral``; each
runs as ``python -m legate_sparse_tpu_torch.apps.<name>``."""
