# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Command-line tools over the port's artifacts and kernels, the ports
of the repo's ``tools/`` scripts that drive the JAX package:
``bench_compare`` (the regression gate over ``bench_torch.py``'s JSON),
``trace_summary`` (per-op and ledger tables of a trace file) and
``tune_irregular`` (the irregular-path shoot-out: the autotune
candidates and the BSR kernel across densities and a clustered
pattern); each runs as ``python -m legate_sparse_tpu_torch.tools.<name>``.
"""
