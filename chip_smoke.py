#!/usr/bin/env python3
# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: the six CUDA kernels from ``legate_sparse_tpu_torch/csrc``
   (one nvcc each, started together), their seconds and ptxas'
   registers and spills;
3. kernels against their plain PyTorch versions on the card: DIA SpMV
   (f32 exact band, f32 holey band with inf/NaN in x at holes and out
   of the band's reach, rectangular, offsets past ±128 and ±2^17,
   bf16), DIA SpMM (f32 exact band, f32 holey band with inf/NaN in X at
   holes, rectangular, k in {1, 7, 16, 1024}, bf16), and where the two
   DIA kernels switch variants, each with inf/NaN in x or X at columns
   that only holes reach: an odd row count, an x/X one element into a
   larger buffer, nd past the unrolled counts (9, 33), k not divisible
   by 4 (5, 17) or 8 (bf16, 12), bf16 with an odd row count, and the
   strided ``A @ X[:, 0]`` and ``A @ X[:, :1]`` through
   ``csr_array.dot`` (each DIA case bit for bit, with the variant it
   took); BSR SpMV and SpMM
   (f32 and bf16: a block-clustered matrix with k in {1, 5, 16, 512},
   and a matrix with a block-row of 40 present blocks, an empty
   block-row and a row of 6,000 entries, with inf and NaN in x and in
   one column of X at stored and unstored columns of present blocks,
   k in {5, 16, 40}, int32 and int64 column indices; the NaN/inf
   pattern equal element for element) and DIA SpGEMM (f32 on offsets
   ±{0, 1, 2}, offsets past ±2^17, a rectangular A·B, bf16; and, in
   f32 and bf16, where it switches between its tiled and general
   variants or meets a tile's edge: n below one tile and not a
   multiple of it, an output diagonal with no pair (its row all 0), A's
   reach at the tiled variant's shared-memory limit and one column
   past, 9 and 33 diagonals, one tensor as A and B, and two calls with
   no synchronisation between; each bit for bit, with the variant it
   took);
4. main path at full size: the 4096x4096-grid 5-point Poisson operator
   (16,777,216 unknowns, f32) built by ``diags(...)`` in CSR on the
   card; ``A @ x`` through ``"dia-kernel"`` against scipy's f64 SpMV,
   the explicit update ``v - 0.25*(A@v) + b``, 500 CG iterations
   (one DIA launch per iteration plus one for ``r0``), and the pde
   app solved to tolerance on a 512x512 grid;
5. SpMM on the same operator: ``A @ X`` for X (2^24, 16) through
   ``"dia-kernel"``, three columns against scipy f64;
6. irregular SpMV and SpMM at 2^20 rows, 8 present 128x128 blocks per
   block-row (65,536 blocks), 16 nonzeros per row, f32, from seed 0:
   the BSR structure's build seconds on the card and the device bytes
   it adds (under 1 MiB), then ``A @ x`` and ``A @ X`` (X (2^20, 16))
   through ``"bsr"`` against scipy f64;
7. SpGEMM: ``A @ A`` for the SpGEMM microbenchmark's banded matrix
   (``examples/common.py::banded_matrix``, 5 ones per row) at 2^24
   rows, f32, through ``"dia-kernel"``, a seeded sample of 4096 rows
   against scipy's f64 product (exact: the values are small integers);
   and ``P @ P`` for the 1024x1024-grid Poisson operator, whose band
   has holes, through ``"esc"``, all of it against scipy;
8. GMG: ``apps/gmg.py`` on the 4096x4096 Poisson grid, f32, linear
   restriction, 8 levels (the coarsest grid used is 32x32): the
   hierarchy's build seconds, every SpGEMM's route and every
   operator's SpMV path, GMG-CG to rtol 1e-5 (iterations, ms/iter, the
   true relative residual in f64 beside its f32 floor) and plain CG on
   the same system and tolerance, which must take more iterations.
   The launch counts are those of the GMG-CG solve alone, and must
   equal what its operators' SpMV paths call for (``dia_spmv``,
   ``bsr_spmv``, and the ELL SpMV of R and P at the fine levels).  Every
   level's Galerkin product is held to scipy's f64 ``R @ A @ P`` on a
   seeded sample of rows, every R and P on the ELL route (the ELL
   kernel) bit for bit to its products summed in slot order
   (``ell_spmv_ordered``) and within 1e-5 of the plain ops, and x to
   the exact solution of the f64 system (by the discrete sine transform
   on the host).  Then (``timing_ell``) the 8192x8192 grid's level-0
   restriction (W 9) and prolongation (W 4), the 8192² GMG cell's ELL
   products, held the same way and to the library product, and timed
   as phase 13 times a kernel, ``bound_ms`` from the bytes the product
   needs (the stored entries, the row counts, x and y) beside the
   padded pack's bytes;
8b. ``timing_csr``: the ``rmat-s25.matvec`` cell's Graph500 graph
   (``spbench/operators/kronecker.py``, SCALE 25, 1.05e9 entries, f32,
   int32 columns) assembled on the card; its ``A @ x`` must take
   ``"csr-rowids"``, launch the CSR kernel once and leave no row ids
   held; the kernel held as ``hold_csr_kernel`` holds it (bit for bit
   ``csr_spmv_ordered`` and the route's product, each entry within 1e-5
   of its terms' magnitudes from the plain ops) and to the library
   product, then timed beside the plain ops and the library, with its
   device ms a kernel, the bytes held and a product's extra bytes, and
   ``bound_ms`` from the operator's least bytes (``spmv_bytes``);
9. the scipy facade (``main_path_facade``) at full size, into the
   kernels: on the pde_4096 operator, ``tril(A) + triu(A, 1)`` equal to
   A bit for bit and its ``@ x`` through ``"dia-kernel"`` equal to
   ``A @ x``; ``(A - A.T).eliminate_zeros()`` and ``A != A.T`` empty;
   ``A.tocoo().tocsr()`` and ``A.tocsc().tocsr()`` equal to A,
   ``A.todia() @ x`` to ``A @ x``; ``setdiag(5.0)`` and then
   ``setdiag(1.0, k=2)`` (a new diagonal) on a copy, whose ``@ x``
   takes the new band through the kernel, held to scipy f64 as in phase
   4, as is ``A.multiply(A) @ x``; sums, ``max``, ``count_nonzero``, a
   row slice and single entries against scipy.  On a block-clustered
   2^20 matrix as in phase 6, ``R + R`` keeps R's pattern and its
   ``@ x`` through ``"bsr"`` equals ``2 * (R @ x)``; ``R.T.T`` equals
   R.  An R-MAT graph (``gallery.rmat(20, nnz_per_row=8, rng=0)``, f64)
   built on the card, ``sum_duplicates`` and ``G + G.T`` against scipy
   (the pattern exactly, the values to 1e-12), its ``@ x`` on the path
   the dispatch picks (``"csr-rowids"``, the CSR kernel, held as in
   8b) against scipy f64.  Each op's card ms (CUDA events, median of 5 after one
   warmup) beside scipy's host seconds for the same op, and the phase's
   launch counts (``dia_spmv`` and ``bsr_spmv`` must be among them);
10. the solvers (``main_path_solvers``) at full width, each from
   ``b = A @ x_true``: on the backward-Euler heat step of the 4096x4096
   grid (SPD) ``cg`` with ``jacobi`` and with ``block_jacobi(.., 32)``
   (its build seconds and ms per apply), ``minres``, ``lsqr`` and
   ``lsmr`` (their transposed products through ``"dia-kernel"`` too),
   damped ``lsqr``/``lsmr`` held by their normal equations, and the
   gradient of ``<w, differentiable_solve(A, b)>`` against a second
   solve; on upwinded convection-diffusion (nonsymmetric) ``gmres``
   (restart 20; its host fetches counted, one cycle run in PyTorch's
   sync debug mode, which must report no synchronisation; the card's
   busy share in a cycle as the device time of the same cycle captured
   in a CUDA graph and replayed over its time run eagerly, both by CUDA
   events, and the share under ``torch.profiler`` beside it) and
   ``bicgstab``; on a
   strictly diagonally dominant 2^20-row block-clustered matrix
   ``bicgstab`` through ``"bsr"``.  Each to rtol 1e-5: its f64 true
   relative residual at most twice that, its error to ``x_true`` at
   most 1e-3, its launch counts exactly what its iteration count calls
   for, its card ms by CUDA events.  Then ``expm_multiply(-0.5 L, B)``
   for four DST eigenmodes of the pde_4096 Laplacian (and one as a
   vector) against ``e^(-lambda/2) B`` at 1e-4, ``s * m`` SpMM (SpMV)
   launches; ``norm`` against scipy; ``mmwrite``/``mmread`` (the numpy
   and the native parser) and ``save_npz``/``load_npz`` of the
   1024x1024-grid Poisson matrix, bit for bit, each read back through
   the DIA kernel; scipy's predicates and a scipy fallback returning a
   tensor on the card.
   Every kernel is held against its plain version at each shape the
   phase gives it (the DIA kernels bit for bit, among them ``dia_spmm``
   at k = 4, the 16-byte variant ``expm_multiply`` runs);
11. the eigensolvers and csgraph (``main_path_spectral``) at full width,
   with the eigen module's scipy fallback replaced by one that raises:
   on pde_4096 (f32) ``eigsh(k=4, which='LA', tol=1e-2)`` (Lanczos, one
   ``dia_spmv`` a step; one Lanczos and one Arnoldi try in PyTorch's
   sync debug mode, which must report no synchronisation before the
   try's one fetch at its end; a Lanczos try's device
   busy share under the profiler; one step's SpMV against its
   reorthogonalisation at 20, 40 and 80 basis rows), ``eigs(k=4,
   which='LM', tol=1e-2)`` (Arnoldi in real arithmetic; the
   nonsymmetric operators are held on the CPU, since convdiff's
   spectrum at this size is pseudospectral) and ``lobpcg`` from a
   seeded X (2^24, 4) for 20 iterations (``dia_spmm`` at k = 4 and 12;
   X orthonormal to 1e-4, theta its Rayleigh quotients to 1e-4), each
   pair held to the closed-form spectrum 4 - 2cos(i pi/4097) - 2cos(j
   pi/4097): its f64 residual at most twice tol times max(|theta|, 1)
   (not for ``lobpcg``), theta within the residual of a closed-form
   eigenvalue and at most lambda_max plus it, ``eigs``'s imaginary
   parts under it; ``svds(k=4, tol=1e-2)`` of the 2^20-row
   block-clustered matrix of phase 6's kind (two ``bsr_spmv`` a step,
   U in one ``bsr_spmm``), its f64 residuals R v - s u and R^T u - s v
   and its values against scipy's ``svds`` (1e-2); shift-invert
   ``eigsh(P, k=4, sigma=0)`` on a 256x128 Poisson grid (cut to size:
   each Lanczos step is a MINRES solve, whose length grows with the
   grid) against the closed-form smallest eigenvalues at 1e-3; on the
   R-MAT graph of phase 9 (scale 20, ``G + G.T``, f64) against scipy
   on the host: ``connected_components`` (count and labels exactly),
   ``laplacian(normed=True)`` (pattern exactly, values to 1e-12, its
   ``@ x`` on the path the dispatch picks), ``dijkstra`` from 8 seeded
   sources (distances to 1e-12, infinities equal, every predecessor
   edge in the graph and tight), ``minimum_spanning_tree`` (edge count,
   weight to 1e-9) and ``floyd_warshall`` on the scale-10 graph (dense
   1024x1024 on the card).  Each run's launches (exactly what its
   iterations call for), host fetches, card ms and host s beside
   scipy's host s where scipy runs the same call; every kernel held
   against its plain version at the phase's shapes (``dia_spmm`` at
   (2^24, 4) and (2^24, 12) bit for bit);
12. compressed storage and the obs core (``main_path_compressed``):
   pde_4096 and a 2^20-row block-clustered matrix in
   ``csr_array.compress()`` storage (bf16 values, int32 indices) times
   a bf16 x and X (k = 16) through the bf16 ``dia_spmv``/``dia_spmm``
   (bit for bit with their plain versions) and ``bsr_spmv``/
   ``bsr_spmm`` (1e-5), and times an f32 x and X through the plain
   widening routes (``"dia-torch"``, ``"ell-bf16"`` or
   ``"csr-rowids-bf16"`` as the JAX package's rules pick) with no
   launch, against the f32 results; a 32,768-column matrix of the same
   kind with int16 indices through both BSR kernels; ``refine="auto"``
   on phase 10's ``cg(step f64)``, ``cg(step f32)`` and
   ``gmres(convdiff f32)`` beside the unrefined solves, each to rtol
   1e-5 by its f64 true residual with exact launch counts; all of it
   with ``obs`` tracing on, its ``op.spmv``/``op.spmm`` counters held
   to the direct SpMVs plus the solvers' (from their spans), the
   ``lat.spmv.*`` counts to ``op.spmv``, the ``transfer.host_sync.*``
   counters to the solvers' host fetches, the Chrome trace written and
   read back, OpenMetrics parsed back to the same counters and
   histogram counts, ``obs.memory``'s device MiB against
   ``torch.cuda``'s, and the host us the instrumentation adds to a
   ``dot``.  Then, tracing off, each bf16 kernel's timing line (ms,
   plain ms, bound, the library's bf16 call where PyTorch has one), the
   widening routes' ms and bytes, and the sliced ELL (and its
   f32-accumulation variant on the bf16 copy) on phase 9's scale-20
   R-MAT graph against csr-rowids;
13. for each kernel at the shapes of phases 4-7: its time (CUDA events
   around 10 calls in a row, median of 25 such samples after warmup),
   the least time the card could take (bytes over 3.35 TB/s,
   operations over 67 TFLOP/s f32; for the BSR kernels the bytes of the
   stored nonzeros, not of dense blocks), the plain version's time and
   one PyTorch library call's time
   (``torch.sparse_csr_tensor @ x``, ``@ X`` or ``@`` another
   ``sparse_csr_tensor``: a yardstick the port never calls).  The
   SpGEMM kernel is timed with B a distinct copy of A's band; beside it
   its device time per call under ``torch.profiler`` over the same 10
   calls (the trace must hold no copy and fewer synchronisations than
   calls), and the aliased ``A @ A`` whole and split into the kernel and
   ``band_to_csr``.  The ELL SpMV, which replaces no TPU kernel, is
   timed in phase 8 and takes two rows of the ``kernels`` line;
14. the distribution layer (``main_path_distributed``,
   ``phase14_rank``) on one NCCL rank started by
   ``parallel.launch.run_ranks`` (a ``FileStore`` rendezvous in a
   temporary directory, no network): pde_4096 sharded by ``shard_csr``
   (a halo of 4096, so the DIA kernels run on a (2^24, 2^24 + 8192)
   window with offsets shifted by +4096 and a merged int8 mask) and
   built by ``dist_poisson2d``: ``dist_spmv`` bit for bit with the
   single-device ``A @ x`` and the kernel with its plain version on the
   window, within 2e-6 of scipy's f64; ``dist_spmm`` with X (2^24, 16)
   bit for bit likewise; ``dist_cg`` for 500 iterations beside
   single-device ``cg`` (ms/iter by CUDA events, the iterates bit for
   bit); ``dist_eigsh(k=4, which='LA', tol=1e-2)`` at phase 11's
   residual bound; ``dist_cg`` and ``dist_minres`` on phase 10's
   ``step``, ``dist_gmres`` (restart 20) and ``dist_bicgstab`` on its
   ``convdiff``, each to rtol 1e-5 by its f64 true residual; a 2^20-row
   block-clustered matrix of phase 6's kind with
   ``force_all_gather=True`` through ``bsr_spmv`` (1e-5 of the
   single-device result and of its plain version) and as a 2-d block
   on the 1x1 grid (plain); ``reshard`` of pde_4096 to the 1x1 2-d
   block and back (bit for bit with ``A @ x`` again) and
   ``reshard_vector`` onto its own placement (no byte moved); the
   general ESC ``dist_spgemm`` of phase 7's 1024² Poisson square, 1d-row
   all-gather and 1x1 2-d, bit for bit with the single-device ESC; the
   banded ``dist_spgemm`` of phase 7's 2^24-row band (``dist_diags``),
   the band realization bit for bit with the single-device ``A @ A``,
   timed beside it, and ``dist_spmv`` of the product through
   ``dia_spmv`` on its window; ``DistGMG``-CG on the 4096² grid at
   phase 8's settings (its build s, the products' realization, the
   V-cycle's routes per level, phase 8's iteration count, x within 2e-4
   of phase 8's iterate, the f64 true residual within twice its f32
   floor, its ELL launches what its routes call for, each R and P row
   block on the ELL route held as in phase 8, a V-cycle's ms and
   profile); every run's launches exactly
   what it calls for, the ``comm.*`` counters empty as their formulas
   predict at one rank, and the timings of the distributed SpMV and
   SpMM beside the kernels on the window (ms, host ms a call, a
   profile of 10 calls).

15. graph analytics and the delta layer: (M) ``main_path_mutation``
   (``phase15_mutation``): ``DeltaCSR`` on pde_4096 with the default
   capacity (1024) and watermark (0.75), the empty buffer's ``dot`` bit
   for bit with ``A @ x`` through ``dia_spmv``, 768 updates of
   ``mutation_stream(23, A, 768, batch=64)`` with a ``dot`` after each
   batch held to the mutated matrix's product on the host (scipy, f64)
   at 1e-6 of ``|A'| |x|``, ``maybe_compact`` at the watermark bit for
   bit with the port's COO constructor of the merged triples (merged on
   the host) and its ``dot`` with that matrix's, a view pinned before
   the swap still serving its version; update ms a batch, the two-term
   ``dot`` ms beside the base's, compaction s, the route before and
   after.  (G) and (MD) ``main_path_graph`` (``phase15_rank``, one NCCL
   rank): BFS, SSSP, connected components and PageRank (``tol=0``, 20
   iterations) on the directed R-MAT graph at scale 21 (2,097,152
   vertices, 33,554,432 sampled edges, f64), each against scipy on the
   host (levels equal to unweighted ``dijkstra``, distances within
   1e-12, the weak-component partition up to relabelling, PageRank
   within 1e-10 of a f64 power iteration), batched BFS and SSSP over 4
   sources bit for bit with the per-source runs, components on the 1x1
   2-d block (the MIN all-reduce arm); sweeps, card ms, host fetches,
   routes, scipy's host s, and a sweep of each product alone;
   ``DistDeltaCSR`` on pde_4096 bit for bit with ``DeltaCSR.dot`` on
   one buffer (the base term ``dia_spmv`` on the window), ``reshard``
   to 2d-block and back with the updates pending, ``compact``.
16. the serving path (``phase16_serving``), ``main_path_serving`` and
   ``timing_serving``: four ``bench.py::_engine_config`` matrices of one
   shape bucket (n = 2^20 - 91, seeds 7, 13, 29, and n = 2^20 - 37; 11
   nonzeros a row and one of 704, f32), each's plain ``dot`` through
   ``"csr-rowids"``.  (E) the engine: A1's cold dispatch (plan and pack)
   and warm ms a request beside the direct ``dot``, bit for bit, with
   no host sync in a warm request; A4 a plan hit; 8 executor requests on
   A1 as one stacked SpMM, each column bit for bit its single dispatch;
   ``multi_matvec`` of A1-A4 as one plan execution, each result bit for
   bit its own plan's; CG on A1 + A1^T + a dominant diagonal (built on
   the card, 100 iterations) with the engine on against off: the same
   iterations and bits, ms/iter of each.  (G) the bench's two-stage,
   three-tenant gateway load on A1-A3 (stage A ``max_batch=4``; stage B
   flush-only, ``tenant_quota=8``: 24 ``queue_full`` rejections) plus
   two tenants served inline, 8 requests a stage each, "banded" on
   pde_4096 (``dia_spmv``) and "blocks" on the 2^20 block-clustered
   matrix (``bsr_spmv``): every ``gateway.*`` total as
   ``P16_GATEWAY_TOTALS`` (held equal to the JAX package's by
   ``tests/test_torch_gateway.py``) plus the inline tenants', every
   served y bit for bit the direct ``A.dot``, A1's against scipy f64 at
   1e-4, requests/s and p50/p99 latency to completion a stage.  (A)
   ``autotune.tune`` (5 trials) on A1 and on phase 9's scale-20 R-MAT
   (f64): each candidate's median, the verdict, the routed ``dot`` bit
   for bit the verdict's candidate, the store through a JSON file; the
   CSR kernel held as in 8b on A1 (and bit for bit the plain ops, whose
   rows it sums in the same order) and on the R-MAT, and timed on both
   beside the plain ops and the atomic ``index_add_``.  (R)
   with ``settings.resil``: one injected ``gateway.dispatch`` fault
   served inline bit for bit, an expired deadline shed at admission.
   ``engine.route.error``, ``gateway.dispatch_fallback`` and
   ``gateway.breaker_inline`` must not move in any sub-run.
17. the resilience layer (``phase17_resilience``, ``phase17_rank``),
   ``main_path_resilience``, with ``settings.resil`` on: (a) pde_4096
   CG, 500 iterations at rtol 0, under a deadline scope, health
   detection and a checkpoint every 100 iterations, bit for bit the
   plain CG with equal iterations, host fetches and launches, ms/iter
   of both, ``resil.ckpt.saves``/``.bytes``/``.ms``; (b) a ``nonfinite``
   fault at ``solver.cg.conv`` raising ``SolverHealthError``
   (``non_finite``, the partial iterate on the card), injected latency
   past a 100 ms deadline raising ``DeadlineExceeded`` at the next
   fetch, one injected ``error`` retried and bit for bit; (c) restart-20
   GMRES on phase 10's convection-diffusion operator, 3 cycles, one
   injected cycle error, bit for bit with resil off; (d) on one NCCL
   rank: ``dist_cg`` with one injected ``dist.cg`` error bit for bit,
   the ABFT-checked ``dist_spmv`` (one check clean; a poisoned y one
   mismatch and one retry, bit for bit) and its ms beside the plain
   one, a ``device_loss`` at one rank re-raised with no recovery
   attempt, the banded 2^24 ``dist_spgemm`` with one injected error bit
   for bit; (e) ``DeltaCSR.compact`` of phase 15's 768 updates under a
   checkpoint scope with one injected ``delta.compact`` error, one
   retry, bit for bit the cold rebuild; (f) ``chaos.run_drill`` (4
   rounds, seed 7) through phase 16's gateway: engine matrix A1, a
   background deadline storm, pde_4096 (``dia_spmv``, mutated mid-storm
   by 100 updates and a compaction) and the 2^20 block-clustered matrix
   (``bsr_spmv``) inline; the report ok, every tenant's ledger
   balanced, the good tenants served whole, nothing left armed; (g)
   with two cards or more, ``dist_cg`` at 2 NCCL ranks losing rank 1
   (``recovery_ladder``), else the line ``{"phase": "recovery_ladder",
   "skipped": "1 card"}``.
18. the operations layer (``phase18_operations``),
   ``main_path_operations``, on phase 16's tenants at its widths: (a)
   phase 16's two-stage gateway load with its two inline kernel tenants,
   three times with ``obs_attrib``/``obs_slo`` off and three times on
   (spans on in both), every result bit for bit between the two,
   the per-tenant ``wall_ns`` equal to the dispatch spans' summed
   durations and the ``comm_bytes`` to ``comm.total_bytes`` exactly,
   requests/s and p99 of each run and the host us a span close that
   attribution adds; (b) ``slo.evaluate()``'s verdicts, an OpenMetrics
   scrape carrying ``slo.*`` and parsing back, ``capacity_report`` and
   its ``capacity.recommendation`` event; (c) pde_4096 and the 2^20
   block-clustered matrix placed, their gateway requests bit for bit
   the unplaced ``A.dot``, a ``migrate_to`` each (priced == recorded
   bytes, the version swap, ``lat.placement.migration``), one controller
   step, and ``chaos.run_drill`` (4 rounds, seed 7) with the banded
   tenant live-migrated mid-storm; (d) with two cards or more, a tenant
   on a 2-rank NCCL submesh bit for bit the one-card product with no
   collective outside the slice (``phase18_submesh_rank``), else
   ``{"phase": "placement_submesh", "skipped": "1 card"}``; (e) the
   phase's Chrome trace and OpenMetrics snapshot through
   ``python -m legate_sparse_tpu_torch.obs.doctor --check`` in a
   subprocess (exit 2 or a crash fails the phase; findings are logged);
   (f) its ``dia_spmv`` and ``bsr_spmv`` launches.
19. the entry points (``phase19_entry_points``),
   ``main_path_entry_points``: (a) ``bench_torch.main()`` at its full
   sizes (every headline field finite and logged on its own line,
   ``vs_baseline`` and ``pde_roofline_ratio`` at most 1.05, ``value`` at
   most 1.05 x 3.35 TB/s, ``path`` "dia"; every field of the twelve
   phases ported from ``bench.py`` finite, its strings strings, one
   shard a card, no recovery field on one card, the serving counts
   that depend on neither the rank count nor the sizes equal to
   ``evidence/BENCH_golden_smoke.json``'s, the saturation totals its
   offered load, attribution's tenant bytes its comm bytes, both
   ``dist_cg`` runs their full budget; the launches of the bench's
   ranks, which its record carries, added to the phase's), and, after
   the runs, the dist and attribution phases' bands row-sharded on one
   NCCL rank (``phase19_dist_rank``), each ``dist_spmv`` through the
   DIA kernel on its window bit for bit the plain DIA SpMV and the
   single-device product, and the
   three inputs it gives the kernels beyond (b)'s and (c)'s shapes
   rebuilt at its sizes and held on a seeded x against the plain
   versions: its BSR matrix (2^13 rows, density 0.05; within 1e-5),
   its bf16 band (2^24 rows, 11 diagonals; bit for bit) and its SpGEMM
   band (2^20 rows, 11 diagonals; bit for bit); (b)
   ``apps.spmv_microbenchmark`` on ``banded_matrix(2^24, 11)`` (f32,
   BASELINE config 2), 20 products into a fresh y and 20 with
   ``out=``, each last product bit for bit the plain DIA SpMV; (c)
   ``apps.spgemm_microbenchmark`` on ``banded_matrix(2^24, 5)`` (config
   5), ``--stable`` (10 products) and fresh (one), each product's band
   bit for bit ``dia_spgemm_plain``'s; (d) ``apps.spectral`` at n = 4000
   and ``P19_SPECTRAL_N`` (4 clusters, k = 6), the eigensolvers' scipy
   fallback replaced by one that raises, components and labels equal to
   host scipy's run of the same script, eigenvalues within 1e-8; (e)
   ``apps.pde`` on the 4096^2 grid: ``--explicit`` (500 steps),
   ``--throughput`` (450 timed CG iterations at rtol 0) and
   ``--distributed --throughput`` on one NCCL rank (the same iterations,
   x within 1e-5 of the single-device iterate), and ``apps.gmg --data
   diffusion --warmup`` on 512^2 (6 levels, rtol 1e-5).  Its launches
   are those of (a)-(e)'s runs, the comparisons after.  The bench's
   JSON is phase 20's input.
20. the tools (``phase20_tools``), ``main_path_tools``: (a)
   ``tools.tune_irregular`` at the JAX tool's sizes (three uniform
   densities at 2^13-2^14 rows, the 2^18-row power-law matrix, the 2^15
   clustered 8x8 FEM pattern, the 2^22-row hyper-sparse matrix): the
   autotune candidates raced and recorded, the winner's chained loop,
   and ``bsr_spmv`` timed on every config that packs (each a line of
   its own), then each of those held against ``bsr_spmv_plain`` on a
   seeded x (1e-5); (b) ``bench_torch.py --smoke`` on the card,
   traced (``build/phase20/bench_smoke.trace.json``; phase 19's timed
   bench stays untraced); (c) ``tools.bench_compare``'s ``main`` (its
   ``python -m`` entry point, in this process) on phase 19's bench
   JSON against itself (exit 0) and against a copy with ``spmv_ms``
   doubled (exit 1); (d) ``tools.trace_summary``'s ``main`` with
   ``--comm --autotune --gateway --latency`` on (b)'s trace (exit 0,
   each table with rows).  Its launches are those of (a)'s and (b)'s runs; (a)'s are
   ``bsr_spmv``'s alone, as many as its packed configs report.

Launch counts come from the kernel wrappers: each is set to 0 just
before a main-path phase (in phases 10-12, 14, 15 and 17-20, each run;
in phase 16, the gateway load) drives its path and read just after; the
``kernels`` line's launches add phases 10's, 11's, 12's, 14's, 15's,
16's, 17's, 18's, 19's and 20's to those of phases 4-7, and its
``max_abs_err`` is the largest over the kernel's shapes in phases 4-7,
10-12, 14, 19 and 20.  The ELL SpMV's two rows (level 0's R and P at
8192², ``replaces`` null) count every launch of its kernel in this
process and in phase 14's rank, and take the largest error of its
checks against the plain ops in phases 8 and 14.  The CSR SpMV's row
(phase 8b's graph, ``replaces`` null) counts every launch of its kernel
in this process: phase by phase (``CsrLaunches``) each must match the
csr-rowids products whose operands the kernel takes (one a product, a
column of an SpMM, a matrix of a stacked batch), phases 8b, 9 and 16
must launch it, and the phases' counts must add up to the total
(``csr_kernel`` line); its ``max_abs_err`` is the largest of its holds
in phases 8b, 9 and 16.  Any
failed check raises, so the script exits non-zero; it exits non-zero
without printing a result when there is no CUDA device.  The last three
lines are the ``kernels`` JSON object, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

import atexit
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

from legate_sparse_tpu_torch.bench_timing import (F32_OPS_PER_S,
                                                  HBM_BYTES_PER_S, INNER,
                                                  REPS, time_ms)
# Each kernel's wrapper by name; ``wrapper.launches`` counts the launches
# of its kernel.
from legate_sparse_tpu_torch.ops import kernel_wrappers as kernel_counters


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def profile_calls(fn, name: str = "") -> dict:
    """``INNER`` calls of ``fn`` in a row under ``torch.profiler``: the
    device time per call of the kernels whose name holds ``name`` (every
    kernel and copy for ``""``; None when the trace holds no device
    time), each with its count and ms a call, the count of every copy
    and synchronisation in the trace, and the host's costliest ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(INNER):
            fn()
        end = torch.cuda.Event()
        end.record()
        end.synchronize()
    rows = prof.key_averages()

    def device_us(e):
        return float(getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0)))

    kern = [e for e in rows if name in e.key and device_us(e) > 0
            and not e.key.startswith(("aten::", "cuda", "nccl:", "c10d::"))]
    host = sorted(rows, key=lambda e: -e.self_cpu_time_total)[:8]
    return {"kernel_device_ms_per_call": (
                sum(device_us(e) for e in kern) / 1e3 / INNER
                if kern else None),
            "kernels": {e.key[:80]: [e.count, device_us(e) / 1e3 / INNER]
                        for e in kern},
            "copies": {e.key: e.count for e in rows
                       if "memcpy" in e.key.lower()},
            "synchronizations": {e.key: e.count for e in rows
                                 if "synchronize" in e.key.lower()},
            "host_self_ms_per_call": {
                e.key[:60]: e.self_cpu_time_total / 1e3 / INNER
                for e in host}}


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def close(y, ref, rtol: float, what: str) -> float:
    """``max |y - ref|`` after checking it within ``rtol`` of ``ref``'s
    largest magnitude (1 at least), and the two finite alike."""
    import torch

    sync()
    check(bool(torch.isfinite(y).all()) == bool(torch.isfinite(ref).all()),
          f"{what}: finiteness differs")
    err = max_abs(y, ref)
    scale = float(ref.float().abs().max()) if ref.numel() else 0.0
    check(err <= rtol * max(scale, 1.0), f"{what}: max |Δ| {err} > "
          f"{rtol} * {scale}")
    return err


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


class CsrLaunches:
    """The CSR SpMV kernel's launches phase by phase, against the
    csr-rowids products that call for them.  It wraps the three products
    of ``ops/spmv.py`` that take the kernel on the card (every caller
    reaches them through the module): one whose operands the kernel
    takes (``spmv.csr_kernel_takes``) calls for one launch
    (``csr_spmv_rowids``, with rows), one a column (``csr_spmm_rowids``)
    or one a real matrix of the batch (``csr_multi_spmv_rowids_masked``:
    its ``kernel`` entries, else ``b``); any other keeps the plain ops.
    ``close(phase)`` checks the launches since the last close against
    those calls and returns the phase's record."""

    def __init__(self):
        import threading

        from legate_sparse_tpu_torch.ops import csr_kernel
        from legate_sparse_tpu_torch.ops import spmv

        self.kernel = csr_kernel.csr_spmv
        self.lock = threading.Lock()
        self.start = self.kernel.launches
        self.counts = {"want": 0, "kernel": 0, "plain_on_card": 0, "cpu": 0}
        self.phases = []
        takes = spmv.csr_kernel_takes

        def spmv_calls(data, indices, _rid, x, rows, *_, **__):
            return (int(rows) > 0, takes(data, indices, x), x)

        def spmm_calls(data, indices, _rid, X, rows, *_, **__):
            k = int(X.shape[1])
            return (k * (int(rows) > 0),
                    k > 0 and takes(data, indices, X[:, 0]), X)

        def multi_calls(data, indices, _rid, _valid, X, _rows, b, *_,
                        kernel=None, **__):
            return (b if kernel is None else len(kernel),
                    X.shape[1] > 0 and takes(data[0], indices[0], X[0]), X)

        for name, calls in (("csr_spmv_rowids", spmv_calls),
                            ("csr_spmm_rowids", spmm_calls),
                            ("csr_multi_spmv_rowids_masked", multi_calls)):
            setattr(spmv, name, self._counted(getattr(spmv, name), calls))

    def _counted(self, real, calls):
        def counted(*args, **kwargs):
            n, kernel, operand = calls(*args, **kwargs)
            with self.lock:
                if kernel:
                    self.counts["want"] += int(n)
                    self.counts["kernel"] += 1
                elif operand.device.type == "cuda":
                    self.counts["plain_on_card"] += 1
                else:
                    self.counts["cpu"] += 1
            return real(*args, **kwargs)

        return counted

    def close(self, phase: str) -> dict:
        with self.lock:
            launched = self.kernel.launches - self.start
            c = self.counts
            rec = {"phase": phase, "launches": launched,
                   "launches_expected": c["want"],
                   "kernel_products": c["kernel"],
                   "plain_products_on_card": c["plain_on_card"],
                   "cpu_products": c["cpu"]}
            self.start = self.kernel.launches
            self.counts = dict.fromkeys(c, 0)
        check(launched == rec["launches_expected"],
              f"phase {phase}: the CSR kernel launched {launched} times, "
              f"its csr-rowids products call for {rec['launches_expected']}")
        self.phases.append(rec)
        return rec


def hold_csr_kernel(name, M, x, y=None) -> dict:
    """The csr-rowids product of the csr_array ``M`` on the card's ``x``,
    as ``csr_array.dot`` runs it (the CSR kernel over the cached offsets
    and schedule): bit for bit its plain twin ``csr_spmv_ordered``, and
    ``y`` (the route's own product) where given; each entry within 1e-5
    (f32) or 1e-12 (f64) of the sum of its terms' magnitudes from the
    plain ops (``csr_spmv_rowids_plain``), and bit for bit them where
    the plain ops sum one thread a row (``M._serial_rows()``)."""
    import torch

    from legate_sparse_tpu_torch.ops import csr_kernel
    from legate_sparse_tpu_torch.ops import spmv as spmv_ops

    check(spmv_ops.csr_kernel_takes(M.data, M.indices, x),
          f"{name}: the CSR kernel must take it")
    rows, serial = M.shape[0], M._serial_rows()
    lengths, sched = M._get_row_lengths(), M._get_csr_schedule()
    got = spmv_ops.csr_spmv_rowids(M.data, M.indices, None, x, rows,
                                   lengths=lengths, serial=serial,
                                   offsets=M.indptr, schedule=sched)
    check(torch.equal(got, csr_kernel.csr_spmv_ordered(
        M.data, M.indices, M.indptr, x)),
        f"{name}: the CSR kernel is not bit for bit csr_spmv_ordered")
    check(y is None or torch.equal(got, y),
          f"{name}: the route's product differs from the kernel's")
    plain = spmv_ops.csr_spmv_rowids_plain(M.data, M.indices, None, x, rows,
                                           lengths=lengths, serial=serial)
    bitwise = bool(torch.equal(got, plain))
    check(bitwise or not serial,
          f"{name}: rows summed one thread a row, not bit for bit plain")
    err = max_abs(got, plain)
    mag = spmv_ops.csr_spmv_rowids_plain(M.data.abs(), M.indices, None,
                                         x.abs(), rows, lengths=lengths,
                                         serial=serial)
    tol = 1e-5 if x.dtype == torch.float32 else 1e-12
    check(bool(((got - plain).abs() <= tol * mag).all()),
          f"{name}: the CSR kernel vs plain: max |Δ| {err} past {tol} of "
          f"the terms' magnitudes")
    hub_rows, chunks = sched.host_counts()
    return {"case": name, "kernel": "csr_spmv", "rows": rows,
            "nnz": int(M.nnz), "dtype": str(x.dtype),
            "index_dtype": str(M.indices.dtype), "serial": serial,
            "hub_rows": hub_rows, "chunks": chunks, "max_abs_err": err,
            "plain_bitwise": bitwise}


def block_clustered_arrays(rng, rows, blocks_per_row, per_block):
    """Canonical CSR arrays: per block-row, ``blocks_per_row`` distinct
    block-columns; per row, ``per_block`` distinct columns in each of
    them; values and columns drawn from ``rng``."""
    import numpy as np

    nbr = rows // 128
    bcols = np.stack([np.sort(rng.choice(nbr, blocks_per_row,
                                         replace=False))
                      for _ in range(nbr)])              # (nbr, k)
    row_bcols = np.repeat(bcols, 128, axis=0)            # (rows, k)
    picks = [rng.integers(0, 128, (rows, blocks_per_row))]
    for _ in range(per_block - 1):
        picks.append((picks[-1] + 1 + rng.integers(
            0, 128 // per_block, (rows, blocks_per_row))) % 128)
    cols = (row_bcols[:, :, None] * 128
            + np.stack(picks, axis=2)).reshape(rows, -1)
    cols = np.sort(cols, axis=1)
    check(bool((np.diff(cols, axis=1) > 0).all()), "columns distinct")
    nnz = cols.size
    indptr = np.arange(rows + 1, dtype=np.int64) * cols.shape[1]
    data = rng.standard_normal(nnz).astype(np.float32)
    return data, cols.reshape(-1).astype(np.int32), indptr


# Phase 14's full widths: the pde_4096 grid (DistGMG's too), the
# block-clustered matrix's rows, the banded product's rows, the ESC
# product's Poisson square and DistGMG's levels.
P14_GRID, P14_ROWS, P14_BAND_ROWS, P14_ESC_GRID, P14_GMG_LEVELS = (
    4096, 1 << 20, 1 << 24, 1024, 8)


def phase14_rank(rank, world, gmg_ref=None):
    """Phase 14 (``main_path_distributed``) on one NCCL rank: the
    distribution layer at the ``P14_*`` widths (pde_4096 and its
    phase-10 kin, the block-clustered matrix, the banded product, the
    ESC product, DistGMG-CG), its kernels at their distributed call
    sites.  ``gmg_ref`` holds phase 8's GMG-CG iteration count, ms/iter
    and the path of its iterate (``.npy``).  Returns the phase's record;
    any failed check raises."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    import torch.distributed

    import importlib

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import linalg, obs
    from legate_sparse_tpu_torch import parallel as P
    from legate_sparse_tpu_torch.apps import gmg as gmg_app
    from legate_sparse_tpu_torch.ops import bsr as bsr_ops
    from legate_sparse_tpu_torch.ops import dia_kernel, ell_kernel
    from legate_sparse_tpu_torch.ops import spmv as spmv_ops
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    spgemm_mod = importlib.import_module(
        "legate_sparse_tpu_torch.parallel.dist_spgemm")
    grid, rows, band_rows, esc_grid, gmg_levels = (
        P14_GRID, P14_ROWS, P14_BAND_ROWS, P14_ESC_GRID, P14_GMG_LEVELS)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(14)
    launches = {name: 0 for name in kernel_counters()}
    runs, vs_plain, timing = {}, {}, {}

    def run(name, fn, **want):
        """``fn()`` with the counts set to 0 just before it; its launches
        must be ``want`` exactly (a callable of the result for counts
        the result decides) and add up in ``launches``."""
        sync()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        for k, v in counts.items():
            launches[k] += v
        full = {k: (v(out) if callable(v) else v) for k, v in want.items()}
        full = {k: full.get(k, 0) for k in counts}
        check(counts == full, f"{name} launched {counts}, its run calls for "
              f"{full}")
        runs[name] = {"launches": {k: v for k, v in counts.items() if v},
                      "card_ms": start.elapsed_time(end), "host_s": secs}
        return out

    def hold(name, kernel, got, want, bitwise):
        err = close(got, want, 1e-6 if bitwise else 1e-5, name)
        check(torch.equal(got, want) or not bitwise,
              f"{name}: kernel and plain version not bit for bit equal")
        vs_plain[name] = {"kernel": kernel, "max_abs_err": err,
                          "bitwise": bool(torch.equal(got, want))}

    def host_ms(fn, calls: int = 200) -> float:
        """Host ms a call of ``fn`` takes to enqueue its work (no sync
        inside the window; the card runs behind)."""
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        sync()
        return (t1 - t0) * 1e3 / calls

    def rel(v, ref) -> float:
        return float(torch.linalg.vector_norm(v.double() - ref.double())
                     / torch.linalg.vector_norm(ref.double()))

    mesh = P.make_row_mesh()
    group = mesh.get_group("rows")
    dev = D.mesh_device(mesh)
    n = grid * grid
    main3 = np.full(n, 4.0, np.float32)
    p1 = np.full(n - 1, -1.0, np.float32)
    p1[np.arange(1, grid) * grid - 1] = 0.0
    pN = np.full(n - grid, -1.0, np.float32)
    offsets = [0, 1, -1, grid, -grid]
    A = sparse.diags([main3, p1, p1, pN, pN], offsets, shape=(n, n),
                     format="csr", dtype=torch.float32)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    y1 = A @ x
    check(A.spmv_path == "dia-kernel", f"pde_4096 @ x took {A.spmv_path}")
    sync()
    t0 = time.perf_counter()
    dA = P.shard_csr(A, mesh)
    sync()
    builds = {"shard_csr_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    dP = P.dist_poisson2d(grid, mesh=mesh, dtype=np.float32)
    sync()
    builds["dist_poisson2d_s"] = time.perf_counter() - t0
    for name, dM in (("shard_csr", dA), ("dist_poisson2d", dP)):
        pk = dM.dia_pack
        check(dM.halo == grid and pk is not None
              and pk.shape == (n, n + 2 * grid) and pk.rmask is not None
              and pk.offsets == tuple(sorted(o + grid for o in offsets)),
              f"{name}: the DIA kernel's window, halo {dM.halo}")

    # dist_spmv on the window through dia_spmv: bit for bit with the
    # single-device A @ x and with its plain version on the window.
    xs = D.shard_vector(x, mesh, dA.rows_padded)
    xw = D._extend_x(x, dA.halo, group)
    for name, dM in (("shard_csr", dA), ("dist_poisson2d", dP)):
        y = run(f"dist_spmv({name})", lambda: P.dist_spmv(dM, xs),
                dia_spmv=1)
        check(dM.spmv_path == "dia-kernel", f"{name}: {dM.spmv_path}")
        check(torch.equal(y.to_local(), y1),
              f"dist_spmv({name}) vs the single-device A @ x")
        pk = dM.dia_pack
        hold(f"dist_spmv({name}) window", "dia_spmv",
             dia_kernel.dia_spmv(pk, xw),
             dia_kernel.dia_spmv_plain(pk.rdata, pk.rmask, xw, pk.offsets,
                                       pk.shape), True)
    A_sp = sp.diags([d.astype(np.float64) for d in (main3, p1, p1, pN, pN)],
                    offsets, shape=(n, n), format="csr")
    xn = x.double().cpu().numpy()
    diff = np.abs(y.to_local().double().cpu().numpy() - A_sp @ xn)
    check(bool(np.all(diff <= 2e-6 * (abs(A_sp) @ np.abs(xn)) + 1e-30)),
          f"dist_spmv vs scipy f64: max |Δ| {diff.max()}")
    vs_scipy = float(diff.max())
    del A_sp, xn, diff

    # dist_spmm, X (2^24, 16), through dia_spmm on the window.
    X = torch.from_numpy(rng.standard_normal((n, 16)).astype(
        np.float32)).to(dev)
    Y1 = A @ X
    Xs = P.shard_dense(X, mesh, dA.rows_padded)
    Y = run("dist_spmm(shard_csr, k=16)", lambda: P.dist_spmm(dA, Xs),
            dia_spmm=1)
    check(torch.equal(Y.to_local(), Y1), "dist_spmm vs the single-device "
          "A @ X")
    Xw = D._extend_x(X, dA.halo, group)
    pk = dA.dia_pack
    hold("dist_spmm window (k=16)", "dia_spmm", dia_kernel.dia_spmm(pk, Xw),
         dia_kernel.dia_spmm_plain(pk.rdata, pk.rmask, Xw, pk.offsets,
                                   pk.shape), True)
    timing["dist_spmm_ms"] = time_ms(lambda: P.dist_spmm(dA, X))
    timing["dia_spmm_window_ms"] = time_ms(lambda: dia_kernel.dia_spmm(pk, Xw))
    timing["single_device_spmm_ms"] = time_ms(lambda: A @ X)
    del X, Y1, Xs, Y, Xw
    torch.cuda.empty_cache()

    # dist_cg for 500 iterations beside the single-device cg, both timed
    # by CUDA events here, and their iterates bit for bit.
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    P.dist_cg(dA, ones, rtol=0.0, maxiter=2)
    linalg.cg(A, ones, rtol=0.0, maxiter=2)
    xd, it = run("dist_cg(pde_4096, 500 iterations)",
                 lambda: P.dist_cg(dA, ones, rtol=0.0, maxiter=500),
                 dia_spmv=501)
    check(it == 500, f"dist_cg ran {it} iterations")
    xc, _ = run("cg(pde_4096, 500 iterations)",
                lambda: linalg.cg(A, ones, rtol=0.0, maxiter=500),
                dia_spmv=501)
    check(torch.equal(xd.to_local(), xc), "dist_cg's iterate vs cg's")
    timing["dist_cg_ms_per_iter"] = (
        runs["dist_cg(pde_4096, 500 iterations)"]["card_ms"] / 500)
    timing["cg_ms_per_iter"] = (
        runs["cg(pde_4096, 500 iterations)"]["card_ms"] / 500)
    del xd, xc, ones

    # dist_eigsh at phase 11's tolerance; one dia_spmv a Lanczos step
    # (a try's one fetch holds 3 m values).
    fetches = []
    real_fetch = linalg._host_fetch

    def counted_fetch(t):
        fetches.append(t.numel())
        return real_fetch(t)

    linalg._host_fetch = counted_fetch
    try:
        w, V = run("dist_eigsh(pde_4096, k=4, LA, tol=1e-2)",
                   lambda: P.dist_eigsh(dA, k=4, which="LA", tol=1e-2),
                   dia_spmv=lambda out: sum(f // 3 for f in fetches))
        steps = sum(f // 3 for f in fetches)
        A64 = A.astype(torch.float64)
        U = V.to_local().double()
        U = U / torch.linalg.vector_norm(U, dim=0, keepdim=True)
        r = torch.linalg.vector_norm(A64 @ U - U * w.double()[None, :],
                                     dim=0).cpu().numpy()
        th = w.double().cpu().numpy()
        check(bool(np.all(r <= 2.0 * 1e-2 * np.maximum(np.abs(th), 1.0))),
              f"dist_eigsh residuals {r} for {th}")
        runs["dist_eigsh(pde_4096, k=4, LA, tol=1e-2)"].update(
            steps=steps, theta=th.tolist(), residual_f64=r.tolist())
        del U, V, A64

        # The phase-10 operators, each solved from b = M @ x_true to rtol
        # 1e-5, held to its f64 true residual (twice the rtol at most)
        # and to x_true (1e-3).
        hole = np.ones(n - 1, np.float32)
        hole[np.arange(1, grid) * grid - 1] = 0.0
        far = np.full(n - grid, -1.0, np.float32)
        five = np.ones(n, np.float32)
        step = sparse.diags([5.0 * five, -hole, -hole, far, far], offsets,
                            shape=(n, n), format="csr", dtype=torch.float32)
        convdiff = sparse.diags([5.0 * five, -0.5 * hole, -1.5 * hole, far,
                                 far], offsets, shape=(n, n), format="csr",
                                dtype=torch.float32)
        x_true = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev)

        def judge(name, M, b, xsol):
            M64 = M.astype(torch.float64)
            xl = xsol.to_local()
            res = rel(M64 @ xl.double(), b)
            err = rel(xl, x_true)
            check(res <= 2e-5, f"{name}: true relative residual {res}")
            check(err <= 1e-3, f"{name}: error to x_true {err}")
            runs[name].update(rel_residual_f64=res, rel_error_to_x_true=err)

        b_step, b_cd = step @ x_true, convdiff @ x_true
        dS, dC = P.shard_csr(step, mesh), P.shard_csr(convdiff, mesh)
        xsol, it = run("dist_cg(step)",
                       lambda: P.dist_cg(dS, b_step, rtol=1e-5),
                       dia_spmv=lambda out: out[1] + 1)
        judge("dist_cg(step)", step, b_step, xsol)
        xsol, it = run("dist_minres(step)",
                       lambda: P.dist_minres(dS, b_step, rtol=1e-5),
                       dia_spmv=lambda out: out[1] + 1)
        judge("dist_minres(step)", step, b_step, xsol)
        fetches.clear()
        xsol, it = run("dist_gmres(convdiff, restart=20)",
                       lambda: P.dist_gmres(dC, b_cd, restart=20, rtol=1e-5),
                       dia_spmv=lambda out: (21 * fetches.count(2)
                                             + fetches.count(1)))
        judge("dist_gmres(convdiff, restart=20)", convdiff, b_cd, xsol)
        runs["dist_gmres(convdiff, restart=20)"].update(
            cycles=fetches.count(2), confirms=fetches.count(1), iters=it)
        xsol, it = run("dist_bicgstab(convdiff)",
                       lambda: P.dist_bicgstab(dC, b_cd, rtol=1e-5),
                       dia_spmv=lambda out: 2 * out[1] + 1)
        judge("dist_bicgstab(convdiff)", convdiff, b_cd, xsol)
    finally:
        linalg._host_fetch = real_fetch
    del step, convdiff, dS, dC, b_step, b_cd, x_true, xsol
    torch.cuda.empty_cache()

    # The timings of the DIA route (tracing off): dist_spmv on the local
    # block, the window it builds, the kernel on the window, and the
    # single-device SpMV; bytes each input read once, each output written
    # once (the band, its int8 mask, the window, y).
    xl = xs.to_local()
    nd = len(offsets)
    timing["dist_spmv_ms"] = time_ms(lambda: P.dist_spmv(dA, xl))
    timing["window_ms"] = time_ms(lambda: D._extend_x(x, dA.halo, group))
    timing["dia_spmv_window_ms"] = time_ms(lambda: dia_kernel.dia_spmv(pk, xw))
    timing["single_device_spmv_ms"] = time_ms(lambda: A @ x)
    timing["dist_spmv_profile"] = profile_calls(lambda: P.dist_spmv(dA, xl))
    timing["dist_spmv_host_ms"] = host_ms(lambda: P.dist_spmv(dA, xl))
    timing["single_device_spmv_host_ms"] = host_ms(lambda: A @ x)
    timing["dia_spmv_window_bytes"] = nd * n * 5 + 4 * (n + 2 * grid) + 4 * n
    timing["window_copy_bytes"] = 2 * 4 * (n + 2 * grid)
    del dP, xw
    torch.cuda.empty_cache()

    # The block-clustered 2^20-row matrix of phase 6's kind: dist_spmv
    # through bsr_spmv against the all-gathered x, then the 2-d block
    # layout on the 1x1 grid (plain PyTorch).
    d, i, p = block_clustered_arrays(rng, rows, 8, 2)
    R = sparse.csr_array((d, i, p), shape=(rows, rows))
    xr = torch.from_numpy(rng.standard_normal(rows).astype(np.float32)).to(dev)
    yr1 = R @ xr
    dR = P.shard_csr(R, mesh, force_all_gather=True)
    xrs = D.shard_vector(xr, mesh, dR.rows_padded)
    yr = run("dist_spmv(block-clustered, all-gather)",
             lambda: P.dist_spmv(dR, xrs), bsr_spmv=1)
    check(dR.spmv_path == "bsr" and dR.bsr is not None,
          f"the all-gather row block took {dR.spmv_path}")
    close(yr.to_local(), yr1, 1e-5, "dist_spmv(bsr) vs the single-device "
          "R @ x")
    st = dR.bsr
    x2d = D._all_gather(xr, group).reshape(-1, 128)
    hold("dist_spmv(bsr) row block", "bsr_spmv", bsr_ops.bsr_spmv(st, x2d),
         bsr_ops.bsr_spmv_plain(st, x2d), False)
    xrl = xrs.to_local()
    timing["dist_spmv_bsr_ms"] = time_ms(lambda: P.dist_spmv(dR, xrl))
    timing["bsr_spmv_row_block_ms"] = time_ms(
        lambda: bsr_ops.bsr_spmv(st, x2d))
    timing["dist_spmv_bsr_profile"] = profile_calls(lambda: P.dist_spmv(dR, xrl))
    timing["dist_spmv_bsr_host_ms"] = host_ms(lambda: P.dist_spmv(dR, xrl))
    timing["single_device_bsr_host_ms"] = host_ms(lambda: R @ xr)
    # The host cost of the one-rank collectives the routes make.
    scalar = torch.zeros((), device=dev)
    timing["collective_host_ms"] = {
        "all_reduce(scalar)": host_ms(
            lambda: torch.distributed.all_reduce(scalar, group=group)),
        "all_gather(2^20 f32)": host_ms(lambda: D._all_gather(xr, group))}
    d2 = P.shard_csr(R, layout="2d-block")
    check(d2.grid == (1, 1), f"2d-block on one rank: grid {d2.grid}")
    x2s = D.shard_vector(xr, d2.mesh, d2.rows_padded, layout="2d-block")
    y2 = run("dist_spmv(block-clustered, 2d-block 1x1)",
             lambda: P.dist_spmv(d2, x2s))
    check(d2.spmv_path == "2d-block", f"2d-block took {d2.spmv_path}")
    runs["dist_spmv(block-clustered, 2d-block 1x1)"].update(
        max_abs_err_vs_single=close(y2.to_local(), yr1, 1e-5,
                                    "2d-block vs the single-device R @ x"))

    # (d) reshard: pde_4096 from 1d-row to the 1x1 2-d block (the plain
    # 2-d SpMV) and back (the DIA kernel on the window again, bit for
    # bit), and a vector onto its own placement, which moves nothing.
    y1 = A @ x
    d2p = P.reshard(dA, layout="2d-block")
    check(d2p.grid == (1, 1) and d2p is not dA, f"reshard: grid {d2p.grid}")
    x2p = D.shard_vector(x, d2p.mesh, d2p.rows_padded, layout="2d-block")
    y2p = run("dist_spmv(pde_4096 resharded 2d-block)",
              lambda: P.dist_spmv(d2p, x2p))
    reshard_rec = {"to_2d_max_abs_err": close(
        y2p.to_local()[:n], y1, 1e-5, "resharded 2d-block vs A @ x")}
    dback = P.reshard(d2p, mesh=mesh, layout="1d-row")
    check(P.dist_plan_fingerprint(dback) == P.dist_plan_fingerprint(dA),
          "reshard back: another plan than the source's")
    yb = run("dist_spmv(pde_4096 resharded back)",
             lambda: P.dist_spmv(dback, xs), dia_spmv=1)
    check(torch.equal(yb.to_local(), y1), "resharded back vs A @ x")
    c0 = obs.counters.snapshot("comm.")
    xs_same = P.reshard_vector(xs, mesh)
    check(torch.equal(xs_same.to_local(), xs.to_local())
          and obs.counters.snapshot("comm.") == c0,
          "reshard_vector onto its own placement moved bytes")
    reshard_rec["vector_same_placement_bytes"] = 0
    del d2p, x2p, y2p, dback, yb, xs_same
    torch.cuda.empty_cache()

    # (c) The general ESC product at one rank: phase 7's 1024^2 Poisson
    # square (holes in its band), 1d-row forced to the all-gather and as
    # the 1x1 2-d block, each bit for bit with the single-device ESC
    # (one rank runs the same ESC on the same entries).
    Pp = gmg_app.poisson2D(esc_grid, dtype=torch.float32, device=dev)
    Cp1 = Pp @ Pp
    check(Pp.spgemm_path == "esc", f"Poisson square took {Pp.spgemm_path}")
    counts1 = (Cp1.indptr[1:] - Cp1.indptr[:-1]).long()
    esc_rec = {"rows": Pp.shape[0], "nnz_a": Pp.nnz, "nnz_c": Cp1.nnz}
    for name, kw in (("1d-row all-gather", {"force_all_gather": True}),
                     ("2d-block 1x1", {"layout": "2d-block"})):
        dPp = P.shard_csr(Pp, mesh, **kw)
        Cd = run(f"dist_spgemm(ESC, {name})", lambda: P.dist_spgemm(dPp, dPp))
        if Cd.grid is None:
            real = spgemm_mod.last_b_realization()
            check(real == ("all_gather", ()), f"ESC realization {real}")
            r_, c_, v_ = D._local_entries(Cd)
        else:
            ln = int(Cd.counts)
            r_, c_, v_ = (Cd.row_ids[:ln].long(), Cd.cols[:ln].long(),
                          Cd.data[:ln])
        check(torch.equal(torch.bincount(r_, minlength=Pp.shape[0]), counts1)
              and torch.equal(c_, Cp1.indices.long())
              and torch.equal(v_, Cp1.data),
              f"dist_spgemm(ESC, {name}) vs the single-device ESC")
        esc_rec[name] = {"nnz_hint": Cd.nnz_hint, "bitwise": True,
                         "ms": time_ms(lambda: P.dist_spgemm(dPp, dPp),
                                       reps=3)}
        del Cd, r_, c_, v_, dPp
    esc_rec["single_device_ms"] = time_ms(lambda: Pp @ Pp, reps=3)
    del Pp, Cp1, counts1
    torch.cuda.empty_cache()

    # (a) The banded distributed A @ A at 2^24 rows: BASELINE config 5's
    # band (5 ones a row) built by dist_diags takes the band realization,
    # bit for bit with the single-device A @ A (the SpGEMM kernel and
    # band_to_csr; small integers, so every sum is exact in f32).  Then
    # dist_spmv of the product through dia_spmv on its window.
    boffs = [-2, -1, 0, 1, 2]
    bdiags = [np.ones(band_rows - abs(o), np.float32) for o in boffs]
    Ab = sparse.diags(bdiags, boffs, shape=(band_rows, band_rows),
                      format="csr", dtype=torch.float32)
    dB = P.dist_diags(bdiags, boffs, shape=(band_rows, band_rows), mesh=mesh,
                      dtype=np.float32)
    del bdiags
    Cb1 = Ab @ Ab
    check(Ab.spgemm_path == "dia-kernel", f"A @ A took {Ab.spgemm_path}")
    c0 = obs.counters.snapshot("dist_spgemm.")
    Cb = run("dist_spgemm(band 2^24)", lambda: P.dist_spgemm(dB, dB))
    took = {k: v - c0.get(k, 0)
            for k, v in obs.counters.snapshot("dist_spgemm.").items()
            if v != c0.get(k, 0)}
    check(took == {"dist_spgemm.realization.band": 1}
          and Cb.dia_data is not None and Cb.dia_pack is not None,
          f"the banded product took {took}")
    r_, c_, v_ = D._local_entries(Cb)
    check(torch.equal(Cb.counts.long(), (Cb1.indptr[1:]
                                         - Cb1.indptr[:-1]).long())
          and torch.equal(c_, Cb1.indices.long())
          and torch.equal(v_, Cb1.data),
          "dist_spgemm(band) vs the single-device A @ A")
    del r_, c_, v_
    band_rec = {"rows": band_rows, "nnz_c": Cb1.nnz,
                "offsets_c": list(Cb.dia_offsets), "halo_c": Cb.halo,
                "bitwise_vs_single": True,
                "ms": time_ms(lambda: P.dist_spgemm(dB, dB), reps=5),
                "single_device_ms": time_ms(lambda: Ab @ Ab, reps=5),
                "profile": profile_calls(lambda: P.dist_spgemm(dB, dB))}
    xb = torch.from_numpy(rng.standard_normal(band_rows).astype(
        np.float32)).to(dev)
    xbs = D.shard_vector(xb, mesh, Cb.rows_padded)
    yb = run("dist_spmv(band product)", lambda: P.dist_spmv(Cb, xbs),
             dia_spmv=1)
    check(Cb.spmv_path == "dia-kernel", f"band product: {Cb.spmv_path}")
    pkb = Cb.dia_pack
    xbw = D._extend_x(xb, Cb.halo, group)
    hold("dist_spmv(band product) window", "dia_spmv",
         dia_kernel.dia_spmv(pkb, xbw),
         dia_kernel.dia_spmv_plain(pkb.rdata, pkb.rmask, xbw, pkb.offsets,
                                   pkb.shape), True)
    yb1 = Cb1 @ xb
    band_rec["spmv_vs_single"] = {
        "max_abs_err": close(yb.to_local(), yb1, 1e-6,
                             "dist_spmv(band product) vs (A @ A) @ x"),
        "bitwise": bool(torch.equal(yb.to_local(), yb1))}
    band_rec["spmv_ms"] = time_ms(lambda: P.dist_spmv(Cb, xbs.to_local()))
    del Ab, dB, Cb, Cb1, xb, xbs, yb, yb1, pkb, xbw
    torch.cuda.empty_cache()

    # (b) DistGMG-CG on the grid^2 Poisson operator at phase 8's settings
    # (linear transfers, gmg_levels levels, rtol 1e-5, b from
    # default_rng(0)): the hierarchy's build seconds, the realization of
    # its Galerkin products, the V-cycle's routes per level, iterations
    # (phase 8's count) and ms/iter, the f64 true residual, and x within
    # 2e-4 of phase 8's iterate (each of the two is within 1e-4 of the
    # exact solution by phase 8's check).
    Ag = gmg_app.poisson2D(grid, dtype=torch.float32, device=dev)
    dG = P.shard_csr(Ag, mesh)
    c0 = obs.counters.snapshot("dist_spgemm.realization.")
    sync()
    t0 = time.perf_counter()
    mg = P.DistGMG(dG, levels=gmg_levels, gridop="linear")
    sync()
    gmg_rec = {"build_s": time.perf_counter() - t0, "realizations": {
        k[len("dist_spgemm.realization."):]: v - c0.get(k, 0)
        for k, v in obs.counters.snapshot(
            "dist_spgemm.realization.").items() if v != c0.get(k, 0)}}
    check(sum(gmg_rec["realizations"].values()) == 2 * (gmg_levels - 1),
          f"DistGMG's products: {gmg_rec['realizations']}")
    b64 = torch.from_numpy(np.random.default_rng(0).random(n)).to(dev)
    bg = b64.float()
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    P.dist_spmv(dG, zero)
    mg.cycle(zero)
    sync()
    gmg_rec["first_cycle_s"] = time.perf_counter() - t0
    levels_A = [dG] + [op[1] for op in mg.operators]

    def gmg_want(route):
        def count(out):
            it = out[1]
            fine = (it + 1) * (dG.spmv_path == route)
            cyc = sum(2 * (levels_A[lv].spmv_path == route)
                      + (mg.operators[lv][0].spmv_path == route)
                      + (mg.operators[lv][2].spmv_path == route)
                      for lv in range(gmg_levels - 1))
            return fine + it * cyc
        return count

    ell0 = ell_kernel.ell_spmv.launches
    xg, itg = run("DistGMG-CG", lambda: P.dist_cg(
        dG, bg, rtol=1e-5, maxiter=200, M=mg.cycle),
        dia_spmv=gmg_want("dia-kernel"), bsr_spmv=gmg_want("bsr"))
    gmg_rec["ell_launches"] = ell_kernel.ell_spmv.launches - ell0
    gmg_rec["ell_launches_expected"] = gmg_want("ell")((xg, itg))
    check(gmg_rec["ell_launches"] == gmg_rec["ell_launches_expected"],
          f"DistGMG-CG launched ell_spmv {gmg_rec['ell_launches']} times, "
          f"its routes call for {gmg_rec['ell_launches_expected']}")
    gmg_rec["routes"] = [{"A": levels_A[lv].spmv_path,
                          "R": mg.operators[lv][0].spmv_path,
                          "P": mg.operators[lv][2].spmv_path}
                         for lv in range(gmg_levels - 1)]
    gmg_rec["iters"] = int(itg)
    gmg_rec["ms_per_iter"] = runs["DistGMG-CG"]["card_ms"] / max(itg, 1)
    check(runs["DistGMG-CG"]["launches"].get("dia_spmv", 0) > 0,
          "DistGMG-CG launched no dia_spmv on its fine level")
    rel_res, floor = gmg_app._residuals(Ag, b64, xg.to_local())
    gmg_rec.update(rel_residual_f64=rel_res, residual_floor=floor)
    check(rel_res <= max(1e-5, 2.0 * floor),
          f"DistGMG-CG true relative residual {rel_res} (floor {floor})")
    if gmg_ref is not None:
        x8 = torch.from_numpy(np.load(gmg_ref["x"])).to(dev)
        gmg_rec["phase8"] = {k: gmg_ref[k] for k in ("iters", "ms_per_iter")}
        gmg_rec["rel_diff_to_phase8_x"] = rel(xg.to_local(), x8)
        check(itg == gmg_ref["iters"], f"DistGMG-CG took {itg} iterations, "
              f"phase 8's GMG-CG {gmg_ref['iters']}")
        check(gmg_rec["rel_diff_to_phase8_x"] <= 2e-4,
              f"DistGMG-CG x vs phase 8's: {gmg_rec['rel_diff_to_phase8_x']}")
        del x8
    # Every V-cycle operator that took the BSR route (the rectangular R
    # and P row blocks of the coarse levels among them): its kernel held
    # against the plain version on an x of its column count, as the
    # route's all-gather gives it at one rank.
    gmg_rec["bsr_held"] = []
    for lv in range(gmg_levels - 1):
        for role, M in (("A", levels_A[lv]), ("R", mg.operators[lv][0]),
                        ("P", mg.operators[lv][2])):
            if M.spmv_path != "bsr":
                continue
            st = M.bsr
            xf = torch.zeros(st.nbc * 128, dtype=st.dtype, device=dev)
            xf[:M.shape[1]] = torch.from_numpy(rng.standard_normal(
                M.shape[1]).astype(np.float32)).to(dev)
            x2d = xf.reshape(-1, 128)
            name = f"DistGMG level {lv} {role} row block"
            hold(name, "bsr_spmv", bsr_ops.bsr_spmv(st, x2d),
                 bsr_ops.bsr_spmv_plain(st, x2d), False)
            gmg_rec["bsr_held"].append([lv, role, list(M.shape)])
    check(len(gmg_rec["bsr_held"]) == sum(
        r == "bsr" for lv in gmg_rec["routes"] for r in lv.values()),
        "a BSR route of the V-cycle was not held against its plain version")
    # Every V-cycle R and P row block that took the ELL route: the kernel
    # bit for bit its slot-order sum and within 1e-5 of the plain ops, on
    # a seeded x as long as the block's columns reach.
    gmg_rec["ell_held"] = []
    for lv in range(gmg_levels - 1):
        for role, M in (("R", mg.operators[lv][0]),
                        ("P", mg.operators[lv][2])):
            if M.spmv_path != "ell":
                continue
            xs = torch.from_numpy(rng.standard_normal(
                int(M.cols.max()) + 1).astype(np.float32)).to(dev)
            pack = (M.data, M.cols, M.counts)
            got = ell_kernel.ell_spmv(*pack, xs)
            name = f"DistGMG level {lv} {role} row block (ELL)"
            hold(name + " vs slot order", "ell_spmv", got,
                 ell_kernel.ell_spmv_ordered(*pack, xs), True)
            hold(name + " vs plain", "ell_spmv", got,
                 spmv_ops.ell_spmv_plain(*pack, xs), False)
            gmg_rec["ell_held"].append([lv, role, list(M.shape)])
    check(len(gmg_rec["ell_held"]) == sum(
        (lv["R"] == "ell") + (lv["P"] == "ell") for lv in gmg_rec["routes"]),
        "an ELL route of the V-cycle was not held against its plain ops")
    gmg_rec["diagnostics"] = mg.diagnostics().splitlines()
    # One V-cycle alone: its ms and where its device time goes.
    gmg_rec["cycle_ms"] = time_ms(lambda: mg.cycle(bg), reps=5)
    gmg_rec["cycle_profile"] = profile_calls(lambda: mg.cycle(bg))
    del Ag, dG, mg, levels_A, xg, b64, bg, zero
    torch.cuda.empty_cache()

    # At one rank no collective moves a byte: the comm ledger holds none,
    # as its formulas predict.
    predicted = {"dist_spmv(pde_4096)": D.spmv_comm_volumes(dA, n, 4),
                 "dist_spmv(bsr)": D.spmv_comm_volumes(dR, rows, 4),
                 "dist_spmv(2d)": D.spmv_comm_volumes(d2, rows, 4)}
    comm = obs.counters.snapshot("comm.")
    check(not any(b for v in predicted.values() for b in v.values())
          and not any(comm.values()),
          f"one rank moved bytes: {predicted}, {comm}")
    return {"runs": runs, "launches": launches,
            "ell_launches": ell_kernel.ell_spmv.launches,
            "kernel_vs_plain": vs_plain,
            "timing": timing, "builds": builds, "band_spgemm": band_rec,
            "esc_spgemm": esc_rec, "dist_gmg": gmg_rec, "reshard": reshard_rec,
            "spmv_max_abs_err_vs_scipy_f64": vs_scipy,
            "comm_counters": comm, "seconds_in_rank":
            time.perf_counter() - t_phase}


# Phase 15's full widths: the R-MAT graph's scale (Graph500's edge
# factor of 16 a vertex), the batched sources, the pde grid of (M) and
# (MD), and (MD)'s updates.
P15_SCALE, P15_SOURCES, P15_GRID, P15_MD_UPDATES = 21, 4, 4096, 256


def pde_diagonals(grid):
    """pde_4096's diagonals and offsets (phase 4) at ``grid``: the
    5-point Poisson stencil, f32, its zeros at a grid row's end
    stored."""
    import numpy as np

    n = grid * grid
    p1 = np.full(n - 1, -1.0, np.float32)
    p1[np.arange(1, grid) * grid - 1] = 0.0
    pN = np.full(n - grid, -1.0, np.float32)
    return ([np.full(n, 4.0, np.float32), p1, p1, pN, pN],
            [0, 1, -1, grid, -grid])


def counted_run(fn):
    """``fn()`` with the kernel counts set to 0 just before it:
    ``(out, counts, card ms by CUDA events, host s)``."""
    import torch

    sync()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    secs = time.perf_counter() - t0
    return out, read_counts(), start.elapsed_time(end), secs


def route_launches(path: str) -> dict:
    """The launches one SpMV on ``path`` makes."""
    return {"dia-kernel": {"dia_spmv": 1}, "bsr": {"bsr_spmv": 1}}.get(
        path, {})


def phase15_mutation(grid=None):
    """Phase 15 (M), ``main_path_mutation``: ``DeltaCSR`` on pde_4096
    (f32) with the default capacity and watermark, fed by
    ``mutation_stream(23, A, 768, batch=64)``: the empty buffer bit for
    bit with ``A @ x`` through ``dia_spmv``; after each batch the
    two-term ``dot`` against the mutated matrix's product on the host
    (scipy, f64: the rows no update touched are ``A @ x``, the touched
    ones summed afresh from the mutated row) at 1e-6 of ``|A'| |x|``;
    ``maybe_compact`` at the watermark, its base bit for bit the port's
    COO constructor of the merged triples (merged on the host by numpy)
    and its ``dot`` bit for bit that matrix's; a view pinned before the
    swap serving the old version bit for bit.  Returns ``(record,
    launches)``; any failed check raises."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import gallery, obs, runtime
    from legate_sparse_tpu_torch.delta import DeltaCSR
    from legate_sparse_tpu_torch.settings import settings
    from legate_sparse_tpu_torch.utils import to_numpy

    grid = P15_GRID if grid is None else grid
    dev = runtime.default_device()
    launches = {name: 0 for name in kernel_counters()}
    runs = {}

    def run(name, fn, want):
        """``fn()`` counted; its launches must be ``want`` (a callable of
        the result for counts the result decides)."""
        out, counts, ms, secs = counted_run(fn)
        for k, v in counts.items():
            launches[k] += v
        want = want(out) if callable(want) else want
        full = {k: want.get(k, 0) for k in counts}
        check(counts == full, f"{name} launched {counts}, its run calls "
              f"for {full}")
        runs.setdefault(name, []).append({"card_ms": ms, "host_s": secs})
        return out

    t_phase = time.perf_counter()
    diagonals, offsets = pde_diagonals(grid)
    n = grid * grid
    A = sparse.diags(diagonals, offsets, shape=(n, n), format="csr",
                     dtype=torch.float32)
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    saved = settings.delta
    settings.delta = True
    try:
        D = DeltaCSR(A)
        check(D.capacity == 1024 and settings.delta_watermark == 0.75,
              f"delta knobs {D.capacity}, {settings.delta_watermark}")
        y_base = A @ x
        y0 = run("dot (empty buffer)", lambda: D.dot(x), {"dia_spmv": 1})
        route_before = D.base.spmv_path
        check(route_before == "dia-kernel" and torch.equal(y0, y_base),
              f"the empty buffer's dot: {route_before}, bit for bit "
              f"{bool(torch.equal(y0, y_base))}")

        # The host reference: the mutated matrix's product in f64.
        A_sp = sp.diags([d.astype(np.float64) for d in diagonals], offsets,
                        shape=(n, n), format="csr")
        xh = x.double().cpu().numpy()
        y_ref = A_sp @ xh
        mag = abs(A_sp) @ np.abs(xh)
        targets, by_row = {}, {}

        def refresh(rows_touched):
            for r in rows_touched:
                s, e = A_sp.indptr[r], A_sp.indptr[r + 1]
                row = dict(zip(A_sp.indices[s:e].tolist(),
                               A_sp.data[s:e].tolist()))
                row.update(by_row[r])
                c = np.fromiter(row.keys(), np.int64)
                v = np.fromiter(row.values(), np.float64)
                y_ref[r] = float(np.dot(v, xh[c]))
                mag[r] = float(np.dot(np.abs(v), np.abs(xh[c])))

        def within(y, what):
            diff = np.abs(y.double().cpu().numpy() - y_ref)
            check(bool(np.all(diff <= 1e-6 * mag + 1e-30)),
                  f"{what}: max |Δ| {diff.max()} against the mutated "
                  f"matrix")
            return float(diff.max())

        t0 = time.perf_counter()
        batches = list(gallery.mutation_stream(23, A, 768, batch=64))
        stream_s = time.perf_counter() - t0
        errs = []
        for rows, cols, vals in batches:
            run("update (64)", lambda: D.update(rows, cols, vals), {})
            touched = set()
            for r, c, v in zip(rows.tolist(), cols.tolist(), vals.tolist()):
                targets[(r, c)] = v
                by_row.setdefault(r, {})[c] = v
                touched.add(r)
            refresh(touched)
            y = run("dot (two terms)", lambda: D.dot(x), {"dia_spmv": 1})
            errs.append(within(y, f"two-term dot at {D.pending} pending"))
        pending = D.pending
        check(len(batches) == 12 and pending >= int(0.75 * D.capacity),
              f"{len(batches)} batches, {pending} pending slots")
        two_term_ms = time_ms(lambda: D.dot(x), reps=5)
        base_ms = time_ms(lambda: D.base.dot(x), reps=5)

        # Compaction at the watermark; a view pinned before the swap.
        v_old = D.view()
        y_old = v_old.dot(x)
        merged = run("maybe_compact", D.maybe_compact, {})
        compact = runs["maybe_compact"][-1]
        check(merged == pending and (D.version, D.pending) == (1, 0),
              f"maybe_compact merged {merged} of {pending}, version "
              f"{D.version}")
        check(torch.equal(v_old.dot(x), y_old),
              "the pinned view no longer serves its version")

        # The cold rebuild: A's stored triples merged with the targets on
        # the host (numpy), through the port's COO constructor.
        t0 = time.perf_counter()
        indptr_h = to_numpy(A.indptr).astype(np.int64)
        key = (np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr_h)) * n
               + to_numpy(A.indices).astype(np.int64))
        val = to_numpy(A.data)
        tk = np.fromiter((r * n + c for r, c in sorted(targets)), np.int64)
        tv = np.fromiter((targets[k] for k in sorted(targets)), np.float64)
        pos = np.searchsorted(key, tk)
        hit = (pos < key.size) & (key[np.minimum(pos, key.size - 1)] == tk)
        val = val.copy()
        val[pos[hit & (tv != 0)]] = tv[hit & (tv != 0)].astype(np.float32)
        keep = np.ones(key.size, dtype=bool)
        keep[pos[hit & (tv == 0)]] = False
        key, val = key[keep], val[keep]
        ins = ~hit & (tv != 0)
        at = np.searchsorted(key, tk[ins])
        key = np.insert(key, at, tk[ins])
        val = np.insert(val, at, tv[ins].astype(np.float32))
        C = sparse.csr_array((val, (key // n, key % n)), shape=(n, n),
                             device=dev)
        cold_s = time.perf_counter() - t0
        del key, val, indptr_h
        same = all(torch.equal(a, b) for a, b in (
            (D.base.data, C.data), (D.base.indices, C.indices),
            (D.base.indptr, C.indptr)))
        check(same, "the compacted base differs from the cold rebuild")
        yc = run("dot (compacted)", lambda: D.dot(x),
                 lambda out: route_launches(D.base.spmv_path))
        route_after = D.base.spmv_path
        yC = C @ x
        check(C.spmv_path == route_after and torch.equal(yc, yC),
              f"the compacted dot ({route_after}) vs the cold rebuild's "
              f"({C.spmv_path})")
        err_after = within(yc, "the compacted dot")
        compacted_ms = time_ms(lambda: D.dot(x), reps=5)
        record = {
            "rows": n, "nnz_before": A.nnz, "nnz_after": D.base.nnz,
            "updates": 768, "batches": len(batches), "pending": pending,
            "stream_host_s": stream_s,
            "update_ms": [r["host_s"] * 1e3 for r in runs["update (64)"]],
            "two_term_dot_card_ms": [r["card_ms"]
                                     for r in runs["dot (two terms)"]],
            "update_ms_median": float(np.median(
                [r["host_s"] * 1e3 for r in runs["update (64)"]])),
            "two_term_dot_card_ms_median": float(np.median(
                [r["card_ms"] for r in runs["dot (two terms)"]])),
            "two_term_dot_ms": two_term_ms, "base_dot_ms": base_ms,
            "compacted_dot_ms": compacted_ms,
            "compaction_s": compact["host_s"],
            "compaction_card_ms": compact["card_ms"],
            "cold_rebuild_host_s": cold_s,
            "route_before": route_before, "route_after": route_after,
            "max_abs_err_two_term": max(errs),
            "max_abs_err_compacted": err_after,
            "counters": obs.counters.snapshot("delta."),
            "seconds": time.perf_counter() - t_phase}
    finally:
        settings.delta = saved
    return record, launches


def phase15_rank(rank, world):
    """Phase 15 (G) and (MD), ``main_path_graph``, on one NCCL rank:
    BFS, SSSP, connected components and PageRank on a directed R-MAT
    graph at ``P15_SCALE`` (f64, Graph500's edge factor 16), each held
    against scipy on the host; batched BFS and SSSP over
    ``P15_SOURCES`` sources bit for bit with the per-source runs;
    components on the 1x1 2-d block (the MIN all-reduce arm); then
    ``DistDeltaCSR`` on pde_4096: bit for bit with the single-device
    ``DeltaCSR.dot`` on one buffer, ``reshard`` to 2d-block and back
    with the updates pending, and ``compact``.  Returns the record;
    any failed check raises."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse import csgraph as scsg

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import gallery, graph, obs
    from legate_sparse_tpu_torch import parallel as P
    from legate_sparse_tpu_torch.delta import DeltaCSR, DistDeltaCSR
    from legate_sparse_tpu_torch.graph import algorithms as galg
    from legate_sparse_tpu_torch.parallel import dist_csr as D
    from legate_sparse_tpu_torch.settings import settings

    t_phase = time.perf_counter()
    mesh = P.make_row_mesh()
    dev = D.mesh_device(mesh)
    launches = {name: 0 for name in kernel_counters()}
    runs = {}

    def run(name, fn, want=None, alg=None, semiring=None):
        """``fn()`` counted and traced: its launches must be ``want`` (a
        callable of the result's route, or none), and the record takes
        the ``dist_spmv`` routes, the sweeps and, for ``alg``, its
        iterations and host fetches."""
        obs.reset_all()
        obs.enable()
        try:
            out, counts, ms, secs = counted_run(fn)
        finally:
            obs.disable()
        paths = sorted({r["attrs"].get("path") for r in obs.records()
                        if r["name"] == "dist_spmv" and "attrs" in r})
        for k, v in counts.items():
            launches[k] += v
        want = want(paths) if callable(want) else (want or {})
        full = {k: want.get(k, 0) for k in counts}
        check(counts == full, f"{name} launched {counts}, its run calls "
              f"for {full}")
        snap = obs.counters.snapshot()
        rec = {"card_ms": ms, "host_s": secs, "routes": paths,
               "launches": {k: v for k, v in counts.items() if v}}
        if semiring == "plus-times":
            rec["sweeps"] = snap.get("op.dist_spmv", 0)
        elif semiring is not None:
            rec["sweeps"] = (snap.get("graph.dist_spmv." + semiring, 0)
                             + snap.get("graph.dist_spmm." + semiring, 0))
        if semiring is not None:
            # The run's card ms over its sweeps: the push operator's
            # build included (``sweep_ms`` has a sweep alone).
            rec["run_ms_per_sweep"] = ms / max(rec["sweeps"], 1)
        if alg is not None:
            rec["iters"] = snap.get(f"graph.{alg}.iters", 0)
            rec["host_fetches"] = snap.get(
                "transfer.host_sync.graph_" + alg, 0)
        runs[name] = rec
        return out

    def scipy_s(name, fn):
        t0 = time.perf_counter()
        out = fn()
        runs[name]["scipy_host_s"] = time.perf_counter() - t0
        return out

    # Warm-up, uncounted: the process group's first collectives and the
    # first launch of each product on a scale-10 graph.
    W = gallery.rmat(10, nnz_per_row=16, rng=1, device=dev)
    graph.bfs(W, [0, 1])
    graph.sssp(W, [0, 1])
    graph.connected_components(W)
    graph.pagerank(W, max_iters=5)
    del W

    # (G) The graph: R-MAT, directed, f64, duplicates kept.
    t0 = time.perf_counter()
    G = gallery.rmat(P15_SCALE, nnz_per_row=16, rng=0, device=dev)
    sync()
    gen_s = time.perf_counter() - t0
    n = G.shape[0]
    Gs = G.toscipy()
    Gi = sp.csr_array((Gs.data, Gs.indices.astype(np.int32),
                       Gs.indptr.astype(np.int32)), shape=Gs.shape)
    g_rec = {"vertices": n, "sampled_edges": G.nnz, "rmat_host_s": gen_s}

    def levels(d):
        return np.where(np.isinf(d), -1, d).astype(np.int32)

    def rel_err(got, ref, what):
        fin = np.isfinite(ref)
        check(np.array_equal(np.isfinite(got), fin), f"{what}: infinities")
        err = float(np.max(np.abs(got[fin] - ref[fin])
                           / np.maximum(np.abs(ref[fin]), 1e-300)))
        check(err <= 1e-12, f"{what}: max rel {err} against scipy")
        return err

    lv = run("bfs", lambda: graph.bfs(G, 0), alg="bfs", semiring="or-and")
    ref = scipy_s("bfs", lambda: scsg.dijkstra(Gi, indices=0,
                                               unweighted=True))
    check(np.array_equal(lv.cpu().numpy(), levels(ref)),
          "bfs: levels differ from scipy's unweighted dijkstra")
    runs["bfs"]["reached"] = int(np.isfinite(ref).sum())
    dd = run("sssp", lambda: graph.sssp(G, 0), alg="sssp",
             semiring="min-plus")
    ref = scipy_s("sssp", lambda: scsg.dijkstra(Gi, indices=0))
    runs["sssp"]["max_rel_err"] = rel_err(dd.cpu().numpy(), ref, "sssp")
    nc, lab = run("connected_components",
                  lambda: graph.connected_components(G), alg="cc",
                  semiring="min-plus")
    rnc, rlab = scipy_s("connected_components",
                        lambda: scsg.connected_components(
                            Gi, directed=True, connection="weak"))
    labh = lab.cpu().numpy()
    check(nc == rnc and len(set(zip(labh.tolist(), rlab.tolist()))) == nc,
          f"connected_components: {nc} vs scipy's {rnc}")
    runs["connected_components"]["components"] = nc
    pr = run("pagerank", lambda: graph.pagerank(G, tol=0.0, max_iters=20),
             want=lambda paths: {"bsr_spmv": 20} if "bsr" in paths else {},
             alg="pagerank", semiring="plus-times")

    def power_iteration():
        S = Gi.copy()
        S.sum_duplicates()
        outdeg = np.diff(S.indptr).astype(np.float64)
        inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)
        ST = sp.csr_array((np.ones(S.nnz), S.indices, S.indptr),
                          shape=S.shape).T.tocsr()
        dang = (outdeg == 0).astype(np.float64)
        r = np.full(n, 1.0 / n)
        for _ in range(20):
            r = 0.85 * (ST @ (r * inv) + (dang @ r) / n) + 0.15 / n
        return r

    rref = scipy_s("pagerank", power_iteration)
    pr_err = float(np.max(np.abs(pr.cpu().numpy() - rref)))
    check(pr_err <= 1e-10 * float(np.max(rref)),
          f"pagerank: max |Δ| {pr_err} against the f64 power iteration")
    runs["pagerank"]["max_abs_err"] = pr_err
    runs["pagerank"]["sum"] = float(pr.sum())

    # Batched sources: one dist_spmm sweep for all, against per-source.
    outdeg = np.diff(Gi.indptr)
    pick = np.random.default_rng(15).choice(np.flatnonzero(outdeg > 0),
                                            P15_SOURCES - 1, replace=False)
    sources = [0] + sorted(int(s) for s in pick)
    lvb = run("bfs(batched)", lambda: graph.bfs(G, sources), alg="bfs",
              semiring="or-and")
    per = [lv] + [run(f"bfs({s})", lambda s=s: graph.bfs(G, s), alg="bfs",
                      semiring="or-and") for s in sources[1:]]
    check(torch.equal(lvb, torch.stack(per)),
          "batched bfs vs the per-source runs")
    ref = scipy_s("bfs(batched)", lambda: scsg.dijkstra(
        Gi, indices=sources, unweighted=True))
    check(np.array_equal(lvb.cpu().numpy(), levels(ref)),
          "batched bfs vs scipy")
    ddb = run("sssp(batched)", lambda: graph.sssp(G, sources), alg="sssp",
              semiring="min-plus")
    per = [dd] + [run(f"sssp({s})", lambda s=s: graph.sssp(G, s),
                      alg="sssp", semiring="min-plus")
                  for s in sources[1:]]
    check(torch.equal(ddb, torch.stack(per)),
          "batched sssp vs the per-source runs")
    ref = scipy_s("sssp(batched)", lambda: scsg.dijkstra(Gi, indices=sources))
    runs["sssp(batched)"]["max_rel_err"] = rel_err(ddb.cpu().numpy(), ref,
                                                   "batched sssp")
    nc2, lab2 = run("connected_components(2d-block)",
                    lambda: graph.connected_components(G, layout="2d-block"),
                    alg="cc", semiring="min-plus")
    check(nc2 == nc and torch.equal(lab2, lab)
          and runs["connected_components(2d-block)"]["routes"]
          == ["2d-block"], "connected_components on the 1x1 2-d block")

    # One sweep of each algorithm's product at steady state, on the
    # operator it builds (CUDA events, 5 samples of 10 calls).
    sweep_ms = {}
    opB, _ = galg._push_operator(G, True, True)
    dB = P.shard_csr(opB, mesh)
    f = torch.zeros(dB.local_len, dtype=torch.bool, device=dev)
    f[sources] = True
    sweep_ms["bfs or-and"] = time_ms(
        lambda: P.dist_spmv(dB, f, semiring="or-and"), reps=5)
    F = torch.zeros((dB.local_len, len(sources)), dtype=torch.bool,
                    device=dev)
    F[sources, torch.arange(len(sources))] = True
    sweep_ms["bfs or-and, batched"] = time_ms(
        lambda: P.dist_spmm(dB, F, semiring="or-and"), reps=5)
    g_rec["push_operator"] = {"nnz": opB.nnz, "route": dB.spmv_path}
    del opB, dB, f, F
    opS, _ = galg._push_operator(G, True, False)
    dS = P.shard_csr(opS, mesh)
    dvec = torch.where(lvb[0] >= 0, 1.0, torch.inf).to(torch.float64)
    dvec = torch.cat([dvec, dvec.new_full((dS.local_len - n,), torch.inf)])
    sweep_ms["sssp min-plus"] = time_ms(
        lambda: P.dist_spmv(dS, dvec, semiring="min-plus"), reps=5)
    del opS, dS, dvec
    M, _, _ = galg._pagerank_operator(G)
    dM = P.shard_csr(M, mesh)
    r = torch.full((dM.local_len,), 1.0 / n, dtype=torch.float64, device=dev)
    sweep_ms["pagerank plus-times"] = time_ms(lambda: P.dist_spmv(dM, r),
                                              reps=5)
    g_rec["pagerank_operator"] = {"nnz": M.nnz, "route": dM.spmv_path}
    del M, dM, r
    g_rec["sweep_ms"] = sweep_ms
    g_rec["sources"] = sources
    del G, Gs, Gi, lv, dd, lab, pr, lvb, ddb, lab2, per
    torch.cuda.empty_cache()

    # (MD) DistDeltaCSR on pde_4096 beside the single-device DeltaCSR.
    saved = settings.delta
    settings.delta = True
    try:
        diagonals, offsets = pde_diagonals(P15_GRID)
        nA = P15_GRID * P15_GRID
        A = sparse.diags(diagonals, offsets, shape=(nA, nA), format="csr",
                         dtype=torch.float32)
        x = torch.from_numpy(np.random.default_rng(16).standard_normal(
            nA).astype(np.float32)).to(dev)
        Dl = DeltaCSR(A)
        dA = P.shard_csr(A, mesh)
        DD = DistDeltaCSR(dA)
        xs = D.shard_vector(x, mesh, dA.rows_padded)
        y = run("DistDeltaCSR.dot (empty)", lambda: DD.dot(xs),
                {"dia_spmv": 1})
        check(torch.equal(y.to_local(), A @ x) and dA.spmv_path
              == "dia-kernel", "the empty DistDeltaCSR.dot vs A @ x")
        for rows, cols, vals in gallery.mutation_stream(
                24, A, P15_MD_UPDATES, batch=64):
            run("DistDeltaCSR.update", lambda: DD.update(rows, cols, vals))
            Dl.update(rows, cols, vals)
        pending = DD.pending
        check(pending == Dl.pending > 0, f"pending {pending}, {Dl.pending}")
        yd = run("DistDeltaCSR.dot", lambda: DD.dot(xs), {"dia_spmv": 1})
        yl = run("DeltaCSR.dot", lambda: Dl.dot(x), {"dia_spmv": 1})
        check(torch.equal(yd.to_local(), yl),
              "DistDeltaCSR.dot vs the single-device DeltaCSR.dot")
        md = {"pending": pending, "dist_dot_ms": time_ms(lambda: DD.dot(xs),
                                                         reps=5),
              "dot_ms": time_ms(lambda: Dl.dot(x), reps=5)}
        D2 = run("reshard(1d-row -> 2d-block)",
                 lambda: P.reshard(DD, layout="2d-block"))
        check(isinstance(D2, DistDeltaCSR) and D2.layout == "2d-block"
              and D2.pending == pending and D2.entries() == DD.entries(),
              "the 2d-block reshard dropped the pending buffer")
        xs2 = D.shard_vector(x, D2.mesh, D2.rows_padded, layout="2d-block")
        y2 = run("DistDeltaCSR.dot (2d-block)", lambda: D2.dot(xs2))
        md["err_2d_block"] = close(y2.to_local(), yl, 1e-5,
                                   "DistDeltaCSR.dot on 2d-block")
        D1 = run("reshard(2d-block -> 1d-row)",
                 lambda: P.reshard(D2, layout="1d-row"))
        check(D1.pending == pending and D1.entries() == DD.entries(),
              "the 1d-row reshard dropped the pending buffer")
        y1 = run("DistDeltaCSR.dot (back on 1d-row)", lambda: D1.dot(xs),
                 {"dia_spmv": 1})
        check(torch.equal(y1.to_local(), yl),
              "DistDeltaCSR.dot back on 1d-row vs DeltaCSR.dot")
        old_base = D1.base
        merged = run("DistDeltaCSR.compact", D1.compact)
        check(merged == pending and (D1.version, D1.pending) == (1, 0)
              and D1.base is not old_base,
              f"DistDeltaCSR.compact merged {merged} of {pending}")
        Dl.compact()
        yc = run("DistDeltaCSR.dot (compacted)", lambda: D1.dot(xs),
                 lambda paths: route_launches(paths[0]) if paths else {})
        ylc = Dl.dot(x)
        md["err_compacted"] = close(yc.to_local(), ylc, 1e-5,
                                    "the compacted DistDeltaCSR.dot")
        md["routes"] = {"dist_compacted": D1.base.spmv_path,
                        "single_compacted": Dl.base.spmv_path}
        md["compaction_s"] = runs["DistDeltaCSR.compact"]["host_s"]
        del A, Dl, dA, DD, D2, D1, old_base, xs, xs2, x
    finally:
        settings.delta = saved
    torch.cuda.empty_cache()
    return {"runs": runs, "launches": launches, "graph": g_rec,
            "dist_delta": md,
            "seconds_in_rank": time.perf_counter() - t_phase}


# Phase 16's full widths: the engine matrices' rows (bench.py's
# ``_engine_config``: n = P16_ROWS - 91 and P16_ROWS - 37, 11 nonzeros a
# row and one row of 704), the pde_4096 grid, the block-clustered
# matrix's rows and the R-MAT scale of phase 9.
P16_ROWS, P16_GRID, P16_IRR_ROWS, P16_RMAT_SCALE = 1 << 20, 4096, 1 << 20, 20

# The ``gateway.*`` totals of the bench's two-stage load on three engine
# matrices: ``tests/test_torch_gateway.py`` holds the same sequence's
# totals equal to the JAX package's, and to these.
P16_GATEWAY_TOTALS = {
    "gateway.admitted": 72, "gateway.dispatched_requests": 72,
    "gateway.dispatches": 13, "gateway.outcome.served": 72,
    "gateway.outcome.shed": 24, "gateway.packed": 3,
    "gateway.rejected.queue_full": 24, "gateway.submitted": 96,
    "gateway.tenant.background.served": 40,
    "gateway.tenant.background.shed": 24,
    "gateway.tenant.background.submitted": 64,
    "gateway.tenant.batch.served": 16,
    "gateway.tenant.batch.submitted": 16,
    "gateway.tenant.interactive.served": 16,
    "gateway.tenant.interactive.submitted": 16,
}


def engine_matrix(n, nnz_per_row=11, seed=7):
    """``bench.py::_engine_config`` as scipy CSR: random columns, one
    heavy row of ``64 * nnz_per_row`` that breaks the ELL and BSR
    budgets, nnz = nnz_per_row * (n + 63), so n = 2^20 - 91 and 2^20 -
    37 share one shape bucket whatever the seed."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    counts = np.full(n, nnz_per_row, dtype=np.int64)
    counts[0] = min(64 * nnz_per_row, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, n, size=nnz).astype(np.int32)
    order = np.lexsort((indices, np.repeat(np.arange(n), counts)))
    data = rng.standard_normal(nnz).astype(np.float32)
    return sp.csr_matrix((data, indices[order], indptr), shape=(n, n))


def phase16_serving():
    """Phase 16, ``main_path_serving``: the serving path (engine,
    executor, gateway, autotune, request resilience) at full width.
    Returns ``(record, timing, launches)``; any failed check raises."""
    import warnings

    import numpy as np
    import scipy.sparse as sp
    import torch

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import autotune, linalg, obs, resilience
    from legate_sparse_tpu_torch import runtime
    from legate_sparse_tpu_torch.engine import (
        Engine, Gateway, RequestExecutor)
    from legate_sparse_tpu_torch.ops import spmv as spmv_ops
    from legate_sparse_tpu_torch.ops.convert import gather_index
    from legate_sparse_tpu_torch.settings import settings

    t_phase = time.perf_counter()
    dev = runtime.default_device()
    g = torch.Generator(device=dev).manual_seed(16)
    rec, timing = {}, {}

    def randx(n, dtype=torch.float32, k=None):
        shape = (n,) if k is None else (n, k)
        return torch.randn(shape, device=dev, dtype=dtype, generator=g)

    def bits(a, b, what):
        check(torch.equal(a, b), f"{what}: not bit for bit")

    def host_syncs(fn):
        """Synchronising CUDA calls ``fn`` makes (sync debug mode)."""
        if dev.type != "cuda":
            fn()
            return 0
        sync()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # (The mode's own notice, that it is a prototype, is no sync.)
        return sum("called a synchronizing" in str(m.message) for m in w)

    def fallbacks():
        return {k: obs.counters.get(k) for k in (
            "engine.route.error", "gateway.dispatch_fallback",
            "gateway.breaker_inline")}

    f0 = fallbacks()
    n = P16_ROWS - 91
    t0 = time.perf_counter()
    S = [engine_matrix(n, seed=s) for s in (7, 13, 29)]
    S.append(engine_matrix(P16_ROWS - 37, seed=7))
    A1, A2, A3, A4 = (sparse.csr_array(M, device=dev) for M in S)
    rec["matrices"] = {"rows": [M.shape[0] for M in S],
                       "nnz": [M.nnz for M in S],
                       "host_build_s": time.perf_counter() - t0}
    x1 = randx(n)
    for name, M in (("A1", A1), ("A2", A2), ("A3", A3), ("A4", A4)):
        M.dot(torch.ones(M.shape[1], device=dev))
        check(M.spmv_path == "csr-rowids",
              f"{name}'s plain dot took {M.spmv_path}")
        check(M._serial_rows(), f"{name}: rows past SERIAL_MAX_ROW")

    # ---- (E) the engine -------------------------------------------------
    eng = Engine()
    sync()
    t0 = time.perf_counter()
    y_cold = eng.matvec(A1, x1)
    sync()
    cold_s = time.perf_counter() - t0
    y_dot = A1.dot(x1)
    bits(y_cold, y_dot, "engine plan vs csr-rowids dot (A1)")
    rec["csr_kernel_held"] = [hold_csr_kernel("engine A1", A1, x1, y_dot)]
    plan_ms = time_ms(lambda: eng.matvec(A1, x1, _checked=True))
    dot_ms = time_ms(lambda: A1.dot(x1))
    # csr-rowids as the dot runs it (the CSR kernel over the cached
    # offsets and schedule) and its plain ops.
    rowids_ms = time_ms(lambda: spmv_ops.csr_spmv_rowids(
        A1.data, A1.indices, None, x1, n, lengths=A1._get_row_lengths(),
        serial=True, offsets=A1.indptr, schedule=A1._get_csr_schedule()))
    rowids_plain_ms = time_ms(lambda: spmv_ops.csr_spmv_rowids_plain(
        A1.data, A1.indices, None, x1, n, lengths=A1._get_row_lengths(),
        serial=True))
    reqs = 50
    sync()
    t0 = time.perf_counter()
    for _ in range(reqs):
        eng.matvec(A1, x1)
    sync()
    warm_req_ms = (time.perf_counter() - t0) * 1e3 / reqs
    warm_syncs = host_syncs(lambda: eng.matvec(A1, x1))
    check(warm_syncs == 0, f"a warm engine request synced {warm_syncs}x")
    h0, m0 = (obs.counters.get("engine.plan.hits"),
              obs.counters.get("engine.plan.misses"))
    x4 = randx(A4.shape[1])
    bits(eng.matvec(A4, x4), A4.dot(x4), "engine plan vs dot (A4)")
    check(obs.counters.get("engine.plan.misses") == m0
          and obs.counters.get("engine.plan.hits") == h0 + 1,
          "A4 must hit A1's plan")
    # The executor: 8 requests on A1 become one stacked SpMM.
    xs = [randx(n) for _ in range(8)]
    ex = RequestExecutor(eng, max_batch=8, queue_depth=64, timeout_ms=0)
    b0 = obs.counters.get("engine.exec.batches")
    try:
        futs = [ex.submit(A1, x) for x in xs]
        ys = [f.result(timeout=120) for f in futs]
    finally:
        ex.shutdown()
    check(obs.counters.get("engine.exec.batches") == b0 + 1,
          "8 requests must make one stacked dispatch")
    for i, (y, x) in enumerate(zip(ys, xs)):
        bits(y, eng.matvec(A1, x, _checked=True), f"stacked column {i}")
    X8 = torch.stack(xs, dim=1)
    stack_ms = time_ms(lambda: eng.matmat(A1, X8, _checked=True))
    # torch's own 2-D segment_reduce against its 1-D one on A1's
    # products: the stack sums every column in the SpMV's order
    # (``row_sums``), whatever these give.
    prod = A1.data * x1[gather_index(A1.indices)]
    lens = A1._get_row_lengths()
    r1 = torch.segment_reduce(prod, "sum", lengths=lens)
    r2 = torch.segment_reduce(prod[:, None], "sum", lengths=lens)[:, 0]
    raw = {"equal": bool(torch.equal(r1, r2)),
           "max_abs_diff": float((r1 - r2).abs().max())}
    # multi_matvec of A1-A4: one plan execution.
    pairs = [(A1, x1), (A2, xs[1]), (A3, xs[2]), (A4, x4)]
    key = eng._key("spmv_multi", n, n, A1.nnz, A1.dtype, k=4)
    e0 = obs.counters.get(f"engine.plan.{key.plan_id}.execs")
    ym = eng.multi_matvec(pairs)
    check(obs.counters.get(f"engine.plan.{key.plan_id}.execs") == e0 + 1,
          "multi_matvec must be one plan execution")
    for i, (y, (M, x)) in enumerate(zip(ym, pairs)):
        bits(y, eng.matvec(M, x, _checked=True), f"multi_matvec slot {i}")
    multi_ms = time_ms(lambda: eng.multi_matvec(pairs, _checked=True))
    # Engine-routed CG on A1 + A1^T + a dominant diagonal, built on the
    # card: the same iterations and bits as with the engine off.
    Ssym = A1 + A1.T
    dom = float((abs(Ssym) @ torch.ones(n, device=dev)).max()) + 1.0
    Spd = Ssym + sparse.eye(n, dtype=np.float32, device=dev) * dom
    b = torch.ones(n, device=dev)
    Spd.dot(b)                      # its structure caches, before timing
    cg_runs = {}
    # Off, on, off, on: a first solve's one-time costs show as the gap
    # between the two runs of one setting.
    for label, on in (("engine_off", False), ("engine_on", True)) * 2:
        settings.engine = on
        try:
            Aop = linalg.make_linear_operator(Spd)
            sync()
            t0 = time.perf_counter()
            xcg, it = linalg.cg(Aop, b, rtol=1e-30, maxiter=100)
            sync()
            ms = (time.perf_counter() - t0) * 1e3 / max(int(it), 1)
        finally:
            settings.engine = False
        run = cg_runs.setdefault(label, {"x": xcg, "iters": int(it),
                                         "ms_per_iter": [],
                                         "engine_closure":
                                         Aop._engine_mv is not None})
        run["ms_per_iter"].append(ms)
        check(int(it) == run["iters"], f"{label}: iterations differ")
        bits(xcg, run["x"], f"{label}: the second solve's iterate")
    check(cg_runs["engine_on"]["engine_closure"],
          "engine-routed CG took no engine closure")
    check(cg_runs["engine_on"]["iters"] == cg_runs["engine_off"]["iters"],
          "engine-routed CG iterations differ")
    bits(cg_runs["engine_on"]["x"], cg_runs["engine_off"]["x"],
         "engine-routed CG iterate")
    rec["engine"] = {
        "cold_s": cold_s, "warm_ms_per_request": warm_req_ms,
        "plan_ms": plan_ms, "dot_ms": dot_ms,
        "warm_request_host_syncs": warm_syncs,
        "a4_plan_hit": True, "executor_batch_ms": stack_ms,
        "executor_ms_per_request": stack_ms / 8,
        "torch_segment_reduce_2d_vs_1d": raw,
        "multi_matvec_ms": multi_ms,
        "cg": {k: {kk: vv for kk, vv in v.items() if kk != "x"}
               for k, v in cg_runs.items()},
        "plans": {k: {kk: v[kk] for kk in ("hits", "execs")}
                  for k, v in eng.stats()["plans"].items()}}
    del Ssym, Spd, Aop, cg_runs, prod, r1, r2, X8, ys, ym
    check(fallbacks() == f0, f"fallback counters moved in (E): "
          f"{fallbacks()} against {f0}")
    # Bytes of one product's work: values and indices read once, the row
    # lengths, x read and y written (the padded pack moves more).
    work_bytes = A1.nnz * 8 + n * 8 + 2 * n * 4
    pk = A1._engine_pack[1]
    pack_bytes = (2 * key.nnz_b * 4 + pk.lengths.numel() * 8
                  + 2 * key.cols_b * 4)
    timing["engine_spmv"] = {"ms": plan_ms,
                             "csr_rowids_kernel_ms": rowids_ms,
                             "csr_rowids_plain_ms": rowids_plain_ms,
                             "dot_ms": dot_ms, "bytes": work_bytes,
                             "pack_bytes": pack_bytes,
                             "bound_ms": work_bytes / HBM_BYTES_PER_S * 1e3}
    timing["engine_spmm_k8"] = {
        "ms": stack_ms, "csr_rowids_kernel_ms": time_ms(
            lambda: spmv_ops.csr_spmm_rowids(
                A1.data, A1.indices, None, torch.stack(xs, dim=1), n,
                lengths=lens, serial=True, offsets=A1.indptr,
                schedule=A1._get_csr_schedule())),
        "bytes": A1.nnz * 8 + n * 8 + 2 * 8 * n * 4}
    timing["engine_spmm_k8"]["bound_ms"] = (
        timing["engine_spmm_k8"]["bytes"] / HBM_BYTES_PER_S * 1e3)
    timing["engine_multi_k4"] = {
        "ms": multi_ms, "csr_rowids_kernel_ms": 4 * rowids_ms,
        "bytes": 4 * work_bytes,
        "bound_ms": 4 * work_bytes / HBM_BYTES_PER_S * 1e3}

    # ---- (G) the gateway under the bench's two-stage load ---------------
    Pd, offsets = pde_diagonals(P16_GRID)
    Pde = sparse.diags(Pd, offsets, shape=(P16_GRID ** 2,) * 2,
                       format="csr", dtype=np.float32, device=dev)
    rng = np.random.default_rng(0)
    d, i, p = block_clustered_arrays(rng, P16_IRR_ROWS, 8, 2)
    Irr = sparse.csr_array((d, i, p), shape=(P16_IRR_ROWS,) * 2,
                           device=dev)
    xp, xi = randx(Pde.shape[1]), randx(P16_IRR_ROWS)
    yp_ref, yi_ref = Pde.dot(xp), Irr.dot(xi)   # builds their structures
    check(Pde.spmv_path == "dia-kernel" and Irr.spmv_path == "bsr",
          f"inline tenants took {Pde.spmv_path}, {Irr.spmv_path}")
    ones = torch.ones(n, device=dev)
    g0 = obs.counters.snapshot("gateway.")
    settings.gateway = True
    stages, futs_all = [], []
    sync()
    reset_counts()
    try:
        for stage, kw in (("A", dict(max_batch=4, tenant_quota=64)),
                          ("B", dict(max_batch=32, tenant_quota=8))):
            gw = Gateway(Engine(), queue_depth=128, rate=0.0, burst=16.0,
                         slack_ms=5.0, timeout_ms=0.0, **kw)
            submitted, done_at, futs = [], {}, []

            def stamp(f, i):
                # A served tensor is only launched: complete it first.
                sync()
                done_at[i] = time.perf_counter()

            def submit(M, x, tenant, qos):
                i = len(futs)
                submitted.append(time.perf_counter())
                f = gw.submit(M, x, tenant=tenant, qos=qos)
                f.add_done_callback(lambda f, i=i: stamp(f, i))
                futs.append((f, M, x, tenant))

            t0 = time.perf_counter()
            try:
                for j in range(8):
                    submit(A1 if j % 2 == 0 else A2, ones, "interactive",
                           "interactive")
                for _ in range(8):
                    submit(A3, ones, "batch", "batch")
                for _ in range(32):
                    submit(A1, ones, "background", "background")
                for _ in range(8):
                    submit(Pde, xp, "banded", "interactive")
                for _ in range(8):
                    submit(Irr, xi, "blocks", "interactive")
                gw.flush()
                for f, *_ in futs:
                    f.result(timeout=300)
            finally:
                gw.shutdown()
            sync()
            wall = time.perf_counter() - t0
            served = [i for i, (f, *_r) in enumerate(futs)
                      if not isinstance(f.result(), resilience.Rejected)]
            lat = np.array([(done_at[i] - submitted[i]) * 1e3
                            for i in served])
            stages.append({"stage": stage, "requests": len(futs),
                           "served": len(served), "wall_s": wall,
                           "requests_per_s": len(served) / wall,
                           "p50_ms": float(np.percentile(lat, 50)),
                           "p99_ms": float(np.percentile(lat, 99))})
            futs_all += futs
    finally:
        settings.gateway = False
    g_launches = read_counts()
    gdelta = {k: v - g0.get(k, 0)
              for k, v in obs.counters.snapshot("gateway.").items()
              if v - g0.get(k, 0)}
    # The two inline tenants add 8 requests a stage each to the load's
    # totals, every one served inline.
    want = dict(P16_GATEWAY_TOTALS)
    for k in ("gateway.submitted", "gateway.outcome.served"):
        want[k] += 32
    want["gateway.inline"] = 32
    for t in ("banded", "blocks"):
        want[f"gateway.tenant.{t}.submitted"] = 16
        want[f"gateway.tenant.{t}.served"] = 16
    check(gdelta == want, f"gateway totals {gdelta} against {want}")
    check(g_launches["dia_spmv"] == 16 and g_launches["bsr_spmv"] == 16,
          f"inline tenants' launches {g_launches}")
    # Every served result bit for bit the direct A.dot (the comparison's
    # launches stay out of the counts read above).
    direct = {}
    for f, M, x, _t in futs_all:
        y = f.result()
        if isinstance(y, resilience.Rejected):
            continue
        if (id(M), id(x)) not in direct:
            direct[(id(M), id(x))] = M.dot(x)
        bits(y, direct[(id(M), id(x))], "gateway result vs A.dot")
    y1 = direct[(id(A1), id(ones))].double().cpu().numpy()
    ref = S[0].astype(np.float64) @ np.ones(n)
    scale = np.abs(S[0]).astype(np.float64) @ np.ones(n)
    a1_rel = float(np.max(np.abs(y1 - ref) / np.maximum(scale, 1e-30)))
    check(a1_rel <= 1e-4, f"A1 @ 1 against scipy f64: {a1_rel}")
    rec["gateway"] = {"stages": stages, "totals": gdelta,
                      "launches": g_launches,
                      "a1_vs_scipy_f64_rel": a1_rel}
    del futs_all, direct
    check(fallbacks() == f0, f"fallback counters moved in (G): "
          f"{fallbacks()} against {f0}")

    # ---- (A) autotune ---------------------------------------------------
    G = sparse.rmat(P16_RMAT_SCALE, nnz_per_row=8, rng=0, device=dev)
    xg = randx(G.shape[1], torch.float64)
    tuned = {}
    settings.autotune = True
    try:
        autotune.reset()
        for name, M, x in (("A1", A1, x1), ("rmat", G, xg)):
            v = autotune.tune(M, x, trials=5)
            h0 = obs.counters.get("autotune.route.hits")
            y = M.dot(x)
            check(M.spmv_path == v.label,
                  f"{name}'s routed dot took {M.spmv_path}")
            check(obs.counters.get("autotune.route.hits") == h0 + 1,
                  f"{name}: no autotune route hit")
            bits(y, autotune.CANDIDATES[v.label].run(M, x, "spmv"),
                 f"{name}'s routed dot vs its verdict's candidate")
            tuned[name] = {"verdict": v.label, "medians_ms": v.timings_ms,
                           "serial_rows": M._serial_rows()}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "verdicts.json")
            store = autotune.VerdictStore(path=path)
            for M in (A1, G):
                k = autotune.key_for(M, "spmv")
                v = autotune.get_store().lookup(k)
                store.record(k, v.label, timings_ms=v.timings_ms,
                             trials=v.trials)
            back = autotune.VerdictStore(path=path)
            check(len(back) == 2 and all(
                back.lookup(autotune.key_for(M, "spmv")).label
                == tuned[name]["verdict"]
                for name, M in (("A1", A1), ("rmat", G))),
                "verdict store JSON round trip")
    finally:
        settings.autotune = False
        autotune.reset()
    rec["autotune"] = tuned
    # csr-rowids beside the atomic ``index_add_`` it replaced (whose sum
    # changes bits from call to call), on A1 and the R-MAT.
    def atomic(M, x):
        prod = M.data * x[gather_index(M.indices)]
        return torch.zeros(M.shape[0], dtype=prod.dtype,
                           device=dev).index_add_(0, M._get_row_ids(), prod)

    rec["csr_kernel_held"].append(hold_csr_kernel("rmat", G, xg))
    for name, M, x in (("A1", A1, x1), ("rmat", G, xg)):
        timing["csr_rowids_" + name] = {
            "kernel_ms": time_ms(lambda: spmv_ops.csr_spmv_rowids(
                M.data, M.indices, None, x, M.shape[0],
                lengths=M._get_row_lengths(), serial=M._serial_rows(),
                offsets=M.indptr, schedule=M._get_csr_schedule()),
                reps=5),
            "plain_ms": time_ms(lambda: spmv_ops.csr_spmv_rowids_plain(
                M.data, M.indices, None, x, M.shape[0],
                lengths=M._get_row_lengths(), serial=M._serial_rows()),
                reps=5),
            "atomic_index_add_ms": time_ms(lambda: atomic(M, x), reps=5),
            "serial_rows": M._serial_rows(), "rows": M.shape[0],
            "nnz": M.nnz, "dtype": str(M.dtype)}
    del G, xg
    check(fallbacks() == f0, f"fallback counters moved in (A): "
          f"{fallbacks()} against {f0}")

    # ---- (R) resilience on the request path -----------------------------
    settings.gateway = True
    settings.resil = True
    settings.resil_backoff_ms = 0.0
    resilience.reset()
    try:
        gw = Gateway(Engine(), max_batch=4, queue_depth=128,
                     tenant_quota=64, rate=0.0, burst=16.0, slack_ms=5.0,
                     timeout_ms=0.0)
        i0 = obs.counters.get("gateway.dispatch_fault_inline")
        try:
            resilience.inject("gateway.dispatch", kind="error", count=1)
            xs4 = [randx(n) for _ in range(4)]
            mats = [A1, A2, A1, A2]
            futs = [gw.submit(M, x, tenant=f"t{j % 2}")
                    for j, (M, x) in enumerate(zip(mats, xs4))]
            for f, M, x in zip(futs, mats, xs4):
                bits(f.result(timeout=120), M.dot(x),
                     "fault-inline result vs A.dot")
            with resilience.deadline.scope(0.0):
                shed = gw.submit(A1, x1, tenant="late").result(timeout=30)
        finally:
            gw.shutdown()
        fault_inline = obs.counters.get("gateway.dispatch_fault_inline") - i0
        check(fault_inline == 1, f"dispatch_fault_inline {fault_inline}")
        check(isinstance(shed, resilience.Rejected)
              and shed.reason == "deadline_shed"
              and shed.site == "gateway.admit",
              f"expired request: {shed!r}")
        rec["resilience"] = {"dispatch_fault_inline": fault_inline,
                             "fired": resilience.faults.fired(
                                 "gateway.dispatch"),
                             "shed": {"reason": shed.reason,
                                      "site": shed.site}}
    finally:
        resilience.reset()
        settings.resil = False
        settings.gateway = False
    f1 = fallbacks()
    check(f1["gateway.dispatch_fallback"] == f0["gateway.dispatch_fallback"]
          and f1["gateway.breaker_inline"] == f0["gateway.breaker_inline"]
          and f1["engine.route.error"] == f0["engine.route.error"],
          f"fallback counters moved in (R): {f1} against {f0}")
    rec["fallback_counters"] = f1
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, timing, g_launches


# Phase 17's full widths: pde_4096's grid (the CG, GMRES, delta and
# distributed systems) and the banded product's rows; the chaos drill's
# tenants take phase 16's widths.
P17_GRID, P17_BAND_ROWS = 4096, 1 << 24


def phase17_resilience():
    """Phase 17 (a)-(c), (e) and (f), ``main_path_resilience``: the
    resilience layer on pde_4096 and phase 16's tenants, in this process.
    Returns ``(record, launches)``; any failed check raises."""
    import numpy as np
    import torch

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import gallery, linalg, obs, resilience
    from legate_sparse_tpu_torch import runtime
    from legate_sparse_tpu_torch.delta import DeltaCSR
    from legate_sparse_tpu_torch.engine import Engine, Gateway
    from legate_sparse_tpu_torch.resilience import chaos
    from legate_sparse_tpu_torch.settings import settings

    t_phase = time.perf_counter()
    dev = runtime.default_device()
    rec = {}
    launches = {name: 0 for name in kernel_counters()}

    def counted(fn):
        out, counts, ms, secs = counted_run(fn)
        for k, v in counts.items():
            launches[k] += v
        return out, counts, ms, secs

    def bits(a, b, what):
        check(torch.equal(a, b), f"{what}: not bit for bit")

    def moved(c0, prefix):
        c1 = obs.counters.snapshot(prefix)
        return {k: v - c0.get(k, 0) for k, v in c1.items()
                if v != c0.get(k, 0)}

    knobs = ("resil", "resil_backoff_ms", "resil_health", "gateway",
             "delta")
    saved = {k: getattr(settings, k) for k in knobs}
    grid = P17_GRID
    n = grid * grid
    diagonals, offsets = pde_diagonals(grid)
    A = sparse.diags(diagonals, offsets, shape=(n, n), format="csr",
                     dtype=torch.float32)
    b = torch.ones(n, device=dev)
    A.dot(b)
    check(A.spmv_path == "dia-kernel", f"pde_4096 took {A.spmv_path}")
    sync_key = "transfer.host_sync.cg_conv"

    def cg(maxiter=500):
        s0 = obs.counters.get(sync_key)
        (x, it), counts, ms, _s = counted(
            lambda: linalg.cg(A, b, rtol=0.0, maxiter=maxiter))
        return x, it, obs.counters.get(sync_key) - s0, counts, ms

    try:
        # (a) The resilient CG against the plain one, after a warm-up
        # (the first use of each elementwise kernel costs once).
        linalg.cg(A, b, rtol=0.0, maxiter=2)
        x_off, it_off, sync_off, c_off, ms_off = cg()
        settings.resil = True
        settings.resil_backoff_ms = 0.0
        settings.resil_health = True
        resilience.reset()
        k0 = obs.counters.snapshot("resil.ckpt.")
        with resilience.deadline.scope(600_000.0), \
                resilience.checkpoint.scope("phase17.cg", every=100) as ck:
            x_on, it_on, sync_on, c_on, ms_on = cg()
        ckpt = moved(k0, "resil.ckpt.")
        check(it_on == it_off == 500 and sync_on == sync_off
              and c_on == c_off,
              f"resilient CG: {it_on} iterations, {sync_on} fetches, "
              f"{c_on} launches against {it_off}, {sync_off}, {c_off}")
        bits(x_on, x_off, "resilient CG vs plain CG")
        check(ck.saves == 5 and ckpt.get("resil.ckpt.saves") == 5
              and ckpt.get("resil.ckpt.bytes") == 5 * 3 * n * 4,
              f"checkpoint ledger {ckpt}, saves {ck.saves}")
        # The first fetch saves, then every 100 iterations: the last
        # snapshot is iteration 425's, whose x a plain solve of 425
        # iterations returns.
        settings.resil = False
        x_snap, _it = linalg.cg(A, b, rtol=0.0, maxiter=ck.iterations)
        settings.resil = True
        check(ck.iterations == 425 and np.array_equal(
            ck.arrays[0], x_snap.cpu().numpy()),
            f"the last snapshot (iteration {ck.iterations}) is not that "
            f"iterate")
        del x_snap
        rec["cg"] = {"iters": it_on, "host_fetches": sync_on,
                     "launches": {k: v for k, v in c_on.items() if v},
                     "ms_per_iter_resil_off": ms_off / it_off,
                     "ms_per_iter_resil_on": ms_on / it_on,
                     "bitwise": True, "ckpt": ckpt,
                     "ckpt_ms_per_save": ckpt["resil.ckpt.ms"] / 5,
                     "ckpt_bytes_per_save": ckpt["resil.ckpt.bytes"] // 5}

        # (b) Typed outcomes on the same system.
        resilience.inject("solver.cg.conv", kind="nonfinite", count=1)
        try:
            linalg.cg(A, b, rtol=0.0, maxiter=500)
            check(False, "a poisoned residual raised nothing")
        except resilience.SolverHealthError as e:
            check(e.report.cause == "non_finite"
                  and e.report.iterations == 25
                  and isinstance(e.partial, torch.Tensor)
                  and e.partial.device == A.device,
                  f"health verdict {e.report}")
            health = {"cause": e.report.cause,
                      "iterations": e.report.iterations,
                      "site": e.report.site}
        resilience.reset()
        settings.resil_health = False
        resilience.inject("solver.cg.conv", kind="latency",
                          latency_ms=200.0, count=1)
        try:
            with resilience.deadline.scope(100.0):
                linalg.cg(A, b, rtol=0.0, maxiter=500)
            check(False, "the deadline raised nothing")
        except resilience.DeadlineExceeded as e:
            check(e.site == "solver.cg.conv" and e.iterations == 25
                  and e.partial is not None, f"deadline outcome {e!r}")
            late = {"site": e.site, "iterations": e.iterations}
        resilience.reset()
        resilience.inject("solver.cg.conv", kind="error", count=1)
        with resilience.deadline.scope(600_000.0):
            x_r, it_r, _s, _c, _ms = cg()
        retried = obs.counters.get("resil.retry.solver.cg.conv")
        check(retried == 1 and it_r == 500, f"retried {retried}x")
        bits(x_r, x_off, "retried CG vs the clean CG")
        resilience.reset()
        rec["typed"] = {"health": health, "deadline": late,
                        "retry": {"retries": retried, "bitwise": True}}
        del x_on, x_r, ck

        # (c) Restart-20 GMRES on phase 10's convection-diffusion
        # operator, 3 cycles, one injected cycle error.
        hole = np.ones(n - 1, np.float32)
        hole[np.arange(1, grid) * grid - 1] = 0.0
        far = np.full(n - grid, -1.0, np.float32)
        convdiff = sparse.diags(
            [np.full(n, 5.0, np.float32), -0.5 * hole, -1.5 * hole, far,
             far], [0, 1, -1, grid, -grid], shape=(n, n), format="csr",
            dtype=torch.float32)
        b_cd = convdiff @ torch.from_numpy(np.random.default_rng(17)
                                           .standard_normal(n)
                                           .astype(np.float32)).to(dev)
        settings.resil = False
        linalg.gmres(convdiff, b_cd, restart=2, maxiter=2)      # warm-up
        (xg0, itg0), cg0, msg0, _s = counted(lambda: linalg.gmres(
            convdiff, b_cd, restart=20, maxiter=60, rtol=0.0))
        settings.resil = True
        resilience.inject("solver.gmres.conv", kind="error", count=1)
        (xg1, itg1), cg1, msg1, _s = counted(lambda: linalg.gmres(
            convdiff, b_cd, restart=20, maxiter=60, rtol=0.0))
        gretry = obs.counters.get("resil.retry.solver.gmres.conv")
        check(itg0 == itg1 == 60 and gretry == 1,
              f"GMRES: {itg0}, {itg1} iterations, {gretry} retries")
        bits(xg1, xg0, "retried GMRES vs resil off")
        resilience.reset()
        rec["gmres"] = {"iters": itg1, "retries": gretry, "bitwise": True,
                        "launches_resil_off": {k: v for k, v in cg0.items()
                                               if v},
                        "launches_resil_on": {k: v for k, v in cg1.items()
                                              if v},
                        "ms_per_cycle_resil_off": msg0 / 3,
                        "ms_per_cycle_resil_on_with_retry": msg1 / 3}
        del convdiff, b_cd, xg0, xg1

        # (e) Compaction of phase 15's 768 updates under a checkpoint
        # scope, one injected delta.compact error.
        settings.delta = True
        D = DeltaCSR(A)
        targets = {}
        for rows, cols, vals in gallery.mutation_stream(23, A, 768,
                                                        batch=64):
            D.update(rows, cols, vals)
            for r, c, v in zip(rows.tolist(), cols.tolist(), vals.tolist()):
                targets[(r, c)] = v
        pending = D.pending
        resilience.inject("delta.compact", kind="error", count=1)
        with resilience.checkpoint.scope("delta.compact", every=1) as ck:
            merged, _c, _ms, compact_s = counted(D.compact)
        cretry = obs.counters.get("resil.retry.delta.compact")
        check(merged == pending and cretry == 1 and ck.saves == 1
              and ck.arrays[0].shape == (pending,),
              f"compaction merged {merged} of {pending}, {cretry} "
              f"retries, {ck.saves} snapshots")
        cold = chaos._cold_rebuild(A, targets)
        for name in ("data", "indices", "indptr"):
            bits(getattr(D.base, name), getattr(cold, name),
                 f"compacted base {name} vs the cold rebuild")
        rec["delta_compact"] = {"updates": 768, "merged": merged,
                                "retries": cretry, "host_s": compact_s,
                                "snapshot_entries": pending,
                                "bitwise_vs_cold": True}
        resilience.reset()
        del D, cold, ck

        # (f) The chaos drill through phase 16's gateway: its engine
        # tenant, a background deadline storm, the two inline tenants
        # (the banded one mutated mid-storm).
        S1 = engine_matrix(P16_ROWS - 91, seed=7)
        S2 = engine_matrix(P16_ROWS - 91, seed=13)
        A1 = sparse.csr_array(S1, device=dev)
        A2 = sparse.csr_array(S2, device=dev)
        rng = np.random.default_rng(0)
        d, i, p = block_clustered_arrays(rng, P16_IRR_ROWS, 8, 2)
        Irr = sparse.csr_array((d, i, p), shape=(P16_IRR_ROWS,) * 2,
                               device=dev)
        g = torch.Generator(device=dev).manual_seed(17)

        def xs(m, k):
            return [torch.randn(m, device=dev, generator=g)
                    for _ in range(k)]

        tenants = [
            {"name": "a1", "qos": "interactive", "A": A1,
             "xs": xs(A1.shape[1], 2)},
            {"name": "background", "qos": "background", "A": A2,
             "xs": xs(A2.shape[1], 2), "deadline_ms": 0.0},
            {"name": "banded", "qos": "interactive", "A": A,
             "xs": xs(n, 2)},
            {"name": "blocks", "qos": "interactive", "A": Irr,
             "xs": xs(P16_IRR_ROWS, 2)}]
        Irr.dot(tenants[3]["xs"][0])
        check(Irr.spmv_path == "bsr", f"blocks tenant took {Irr.spmv_path}")
        settings.gateway = True
        gw = Gateway(Engine(), max_batch=8, queue_depth=128,
                     tenant_quota=64, rate=0.0, burst=16.0, slack_ms=5.0,
                     timeout_ms=0.0)
        try:
            report, drill_counts, _ms, drill_s = counted(
                lambda: chaos.run_drill(
                    gw, tenants, rounds=4, seed=7,
                    mutation={"tenant": "banded", "updates": 100,
                              "seed": 11}))
        finally:
            gw.shutdown()
        check(report.ok(), f"chaos drill violations {report.violations}")
        for name, t in report.per_tenant.items():
            check(t["submitted"] == t["served"] + t["shed"] + t["error"],
                  f"tenant {name} ledger {t}")
            if name != "background":
                check(t["served"] == t["submitted"] == 8,
                      f"good tenant {name} lost requests: {t}")
        check(report.submitted == 32 and report.mutations == 10
              and report.compactions == 1,
              f"drill report {report}")
        check(not resilience.faults.armed(), "a fault stayed armed")
        check(drill_counts["dia_spmv"] > 0 and drill_counts["bsr_spmv"] > 0,
              f"the drill's launches {drill_counts}")
        rec["chaos"] = {"rounds": report.rounds, "seed": 7,
                        "submitted": report.submitted,
                        "served": report.served, "shed": report.shed,
                        "errors": report.errors,
                        "faults_armed": report.faults_armed,
                        "faults_fired": report.faults_fired,
                        "mutations": report.mutations,
                        "compactions": report.compactions,
                        "per_tenant": report.per_tenant,
                        "launches": {k: v for k, v in drill_counts.items()
                                     if v},
                        "host_s": drill_s}
        del tenants, A1, A2, Irr, S1, S2
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        resilience.reset()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, launches


def phase17_rank(rank, world):
    """Phase 17 (d) on one NCCL rank: ``dist_cg`` on pde_4096 with one
    injected ``dist.cg`` error, the ABFT-checked ``dist_spmv`` (a clean
    pass, a poisoned y retried) and its ms beside the plain one, a
    ``device_loss`` at one rank re-raised, and the banded 2^24
    ``dist_spgemm`` with one injected ``dist.spgemm`` error.  Returns
    the record; any failed check raises."""
    import numpy as np
    import torch

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import obs, resilience
    from legate_sparse_tpu_torch import parallel as P
    from legate_sparse_tpu_torch.parallel import dist_csr as D
    from legate_sparse_tpu_torch.settings import settings

    t_phase = time.perf_counter()
    launches = {name: 0 for name in kernel_counters()}

    def counted(fn):
        out, counts, ms, secs = counted_run(fn)
        for k, v in counts.items():
            launches[k] += v
        return out, counts, ms, secs

    def bits(a, b, what):
        check(torch.equal(a, b), f"{what}: not bit for bit")

    mesh = P.make_row_mesh()
    dev = D.mesh_device(mesh)
    grid = P17_GRID
    n = grid * grid
    diagonals, offsets = pde_diagonals(grid)
    dA = P.shard_csr(sparse.diags(diagonals, offsets, shape=(n, n),
                                  format="csr", dtype=torch.float32), mesh)
    b = np.ones(n, np.float32)
    saved = {k: getattr(settings, k) for k in ("resil", "resil_backoff_ms",
                                                "resil_abft")}
    rec = {}
    try:
        settings.resil = True
        settings.resil_backoff_ms = 0.0
        resilience.reset()
        P.dist_cg(dA, b, rtol=0.0, maxiter=2)       # the first collectives
        (x0, it0), c0, ms0, _s = counted(
            lambda: P.dist_cg(dA, b, rtol=0.0, maxiter=200))
        resilience.inject("dist.cg", kind="error", count=1)
        (x1, it1), c1, ms1, _s = counted(
            lambda: P.dist_cg(dA, b, rtol=0.0, maxiter=200))
        r_cg = obs.counters.get("resil.retry.dist.cg")
        check(it0 == it1 == 200 and r_cg == 1 and dA.spmv_path
              == "dia-kernel", f"dist_cg: {it0}, {it1}, {r_cg} retries, "
              f"{dA.spmv_path}")
        bits(x1.to_local(), x0.to_local(), "retried dist_cg")
        rec["dist_cg"] = {"iters": it1, "retries": r_cg, "bitwise": True,
                          "ms_per_iter": ms0 / it0,
                          "launches": {k: v for k, v in c1.items() if v}}
        resilience.reset()
        del x0, x1

        x = D.shard_vector(torch.from_numpy(
            np.random.default_rng(17).standard_normal(n).astype(
                np.float32)).to(dev), mesh, dA.rows_padded)
        y_plain = P.dist_spmv(dA, x).to_local().clone()
        plain_ms = time_ms(lambda: P.dist_spmv(dA, x))
        settings.resil_abft = True
        a0 = obs.counters.snapshot("resil.")
        y, ca, _ms, _s = counted(lambda: P.dist_spmv(dA, x))
        a1 = obs.counters.snapshot("resil.")
        resilience.inject("dist.spmv.abft", kind="nonfinite", count=1)
        y2, cb, _ms, _s = counted(lambda: P.dist_spmv(dA, x))
        a2 = obs.counters.snapshot("resil.")

        def d(c0, c1, k):
            return c1.get(k, 0) - c0.get(k, 0)

        abft = {"checks_clean": d(a0, a1, "resil.abft.checks"),
                "mismatch": d(a1, a2, "resil.abft.mismatch"),
                "retries": d(a1, a2, "resil.retry.dist.spmv"),
                "launches_clean": {k: v for k, v in ca.items() if v},
                "launches_poisoned": {k: v for k, v in cb.items() if v}}
        check(abft["checks_clean"] == 1 and abft["mismatch"] == 1
              and abft["retries"] == 1, f"ABFT ledger {abft}")
        bits(y.to_local(), y_plain, "ABFT dist_spmv vs plain")
        bits(y2.to_local(), y_plain, "retried ABFT dist_spmv vs plain")
        resilience.reset()
        abft["ms"] = time_ms(lambda: P.dist_spmv(dA, x))
        abft["plain_ms"] = plain_ms
        settings.resil_abft = False
        rec["abft"] = abft

        a0 = obs.counters.get("resil.recovery.attempts")
        resilience.inject("solver.cg.conv", "device_loss", after=1)
        try:
            with resilience.checkpoint.scope("dist.cg", every=25):
                P.dist_cg(dA, b, rtol=0.0, maxiter=100)
            check(False, "a device loss at one rank returned")
        except resilience.DeviceLost as e:
            attempts = obs.counters.get("resil.recovery.attempts") - a0
            check(attempts == 0, f"{attempts} recovery attempts")
            rec["device_loss"] = {"reraised": True, "attempts": attempts,
                                  "site": e.site}
        resilience.reset()
        del dA, x, y, y2, y_plain
        torch.cuda.empty_cache()

        band_rows = P17_BAND_ROWS
        boffs = [-2, -1, 0, 1, 2]
        bdiags = [np.ones(band_rows - abs(o), np.float32) for o in boffs]
        dB = P.dist_diags(bdiags, boffs, shape=(band_rows, band_rows),
                          mesh=mesh, dtype=np.float32)
        del bdiags
        C0, cs0, msb0, _s = counted(lambda: P.dist_spgemm(dB, dB))
        resilience.inject("dist.spgemm", kind="error", count=1)
        C1, cs1, msb1, _s = counted(lambda: P.dist_spgemm(dB, dB))
        r_sg = obs.counters.get("resil.retry.dist.spgemm")
        check(r_sg == 1, f"dist.spgemm retried {r_sg}x")
        for name in ("dia_data", "dia_mask", "counts", "data", "cols"):
            u, v = getattr(C0, name), getattr(C1, name)
            check((u is None) == (v is None)
                  and (u is None or torch.equal(u, v)),
                  f"retried dist_spgemm {name}")
        check(C1.dia_offsets == C0.dia_offsets, "dist_spgemm offsets")
        rec["dist_spgemm"] = {"rows": band_rows, "retries": r_sg,
                              "bitwise": True, "card_ms": msb0,
                              "card_ms_with_retry": msb1}
        resilience.reset()
        del dB, C0, C1
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        resilience.reset()
    torch.cuda.empty_cache()
    rec["launches"] = launches
    rec["seconds_in_rank"] = time.perf_counter() - t_phase
    return rec


def phase17_ladder_rank(rank, world):
    """Phase 17 (g) on 2 NCCL ranks: ``dist_cg`` on pde_4096 under a
    checkpoint scope (every 25 iterations) loses rank 1 at its third
    fetch; rank 0 recovers alone (50 iterations restored, 200 in all,
    the iterate finite) and rank 1 leaves with ``DeviceLost``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import obs, resilience
    from legate_sparse_tpu_torch import parallel as P
    from legate_sparse_tpu_torch.settings import settings

    n = P17_GRID * P17_GRID
    diagonals, offsets = pde_diagonals(P17_GRID)
    dA = P.shard_csr(sparse.diags(diagonals, offsets, shape=(n, n),
                                  format="csr", dtype=torch.float32))
    settings.resil = True
    settings.resil_backoff_ms = 0.0
    resilience.inject("solver.cg.conv", "device_loss", after=2, device=1)
    c0 = obs.counters.snapshot("resil.recovery.")
    try:
        with resilience.checkpoint.scope("dist.cg", every=25):
            x, it = P.dist_cg(dA, np.ones(n, np.float32), rtol=0.0,
                              maxiter=200)
        moved = {k: v - c0.get(k, 0) for k, v in
                 obs.counters.snapshot("resil.recovery.").items()}
        check(it == 200 and moved["resil.recovery.succeeded"] == 1
              and moved["resil.recovery.restored_iters"] == 50
              and bool(torch.isfinite(x.to_local()).all()),
              f"the survivor's recovery: {it} iterations, {moved}")
        out = {"iters": it, "moved": moved,
               "shards_after": x.device_mesh.size()}
    except resilience.DeviceLost:
        out = {"lost": True}
    finally:
        settings.resil = False
        resilience.reset()
    torch.cuda.synchronize()
    dist.barrier()
    return out


# Phase 18 runs on phase 16's tenants at phase 16's widths; its doctor
# artifacts land under the build directory.
P18_REPEATS = 7
P18_SPAN_CLOSES = 20_000


def phase18_load(tenants, sub, reset_counts_too=False):
    """Phase 16's two-stage gateway load (``sub``: the engine tenants
    A1-A3 and the inline "banded"/"blocks" tenants' matrices and
    operands) through fresh gateways: ``(ys, stages)``, every served y in
    submission order and each stage's requests/s and latency
    percentiles to completion."""
    import numpy as np

    from legate_sparse_tpu_torch import resilience
    from legate_sparse_tpu_torch.engine import Engine, Gateway

    A1, A2, A3, ones, Pde, xp, Irr, xi = sub
    ys, stages = [], []
    for stage, kw in (("A", dict(max_batch=4, tenant_quota=64)),
                      ("B", dict(max_batch=32, tenant_quota=8))):
        gw = Gateway(Engine(), queue_depth=128, rate=0.0, burst=16.0,
                     slack_ms=5.0, timeout_ms=0.0, **kw)
        submitted, done_at, futs = [], {}, []

        def stamp(f, i):
            sync()
            done_at[i] = time.perf_counter()

        def submit(M, x, tenant, qos):
            i = len(futs)
            submitted.append(time.perf_counter())
            f = gw.submit(M, x, tenant=tenant, qos=qos)
            f.add_done_callback(lambda f, i=i: stamp(f, i))
            futs.append(f)

        t0 = time.perf_counter()
        try:
            for j in range(8):
                submit(A1 if j % 2 == 0 else A2, ones, "interactive",
                       "interactive")
            for _ in range(8):
                submit(A3, ones, "batch", "batch")
            for _ in range(32):
                submit(A1, ones, "background", "background")
            for _ in range(8):
                submit(Pde, xp, tenants[0], "interactive")
            for _ in range(8):
                submit(Irr, xi, tenants[1], "interactive")
            gw.flush()
            for f in futs:
                f.result(timeout=300)
        finally:
            gw.shutdown()
        sync()
        wall = time.perf_counter() - t0
        served = [i for i, f in enumerate(futs)
                  if not isinstance(f.result(), resilience.Rejected)]
        lat = np.array([(done_at[i] - submitted[i]) * 1e3 for i in served])
        stages.append({"stage": stage, "served": len(served),
                       "wall_s": wall, "requests_per_s": len(served) / wall,
                       "p50_ms": float(np.percentile(lat, 50)),
                       "p99_ms": float(np.percentile(lat, 99))})
        ys += [futs[i].result() for i in served]
    return ys, stages


def phase18_operations():
    """Phase 18 (a)-(c), (e) and (f), ``main_path_operations``: the
    operations layer (attribution, SLOs, capacity, placement, the
    doctor) on phase 16's tenants, in this process.  Returns ``(record,
    launches)``; any failed check raises."""
    import numpy as np
    import torch

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import obs, placement, resilience, runtime
    from legate_sparse_tpu_torch.engine import Engine, Gateway
    from legate_sparse_tpu_torch.obs import attrib, capacity, export, slo
    from legate_sparse_tpu_torch.placement import submesh as psub
    from legate_sparse_tpu_torch.resilience import chaos
    from legate_sparse_tpu_torch.settings import settings

    t_phase = time.perf_counter()
    dev = runtime.default_device()
    g = torch.Generator(device=dev).manual_seed(18)
    rec = {}
    launches = {name: 0 for name in kernel_counters()}
    knobs = ("gateway", "resil", "resil_backoff_ms", "obs_attrib",
             "obs_slo", "obs_slo_watchdog_ms", "placement")
    saved = {k: getattr(settings, k) for k in knobs}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    def bits(a, b, what):
        check(torch.equal(a, b), f"{what}: not bit for bit")

    def randx(m):
        return torch.randn(m, device=dev, generator=g)

    def moved(c0, name):
        return obs.counters.get(name) - c0.get(name, 0)

    n = P16_ROWS - 91
    t0 = time.perf_counter()
    A1, A2, A3 = (sparse.csr_array(engine_matrix(n, seed=s), device=dev)
                  for s in (7, 13, 29))
    Pd, offsets = pde_diagonals(P16_GRID)
    Pde = sparse.diags(Pd, offsets, shape=(P16_GRID ** 2,) * 2,
                       format="csr", dtype=np.float32, device=dev)
    rng = np.random.default_rng(0)
    d, i, p = block_clustered_arrays(rng, P16_IRR_ROWS, 8, 2)
    Irr = sparse.csr_array((d, i, p), shape=(P16_IRR_ROWS,) * 2,
                           device=dev)
    xp, xi = randx(Pde.shape[1]), randx(P16_IRR_ROWS)
    ones = torch.ones(n, device=dev)
    yp_ref, yi_ref = Pde.dot(xp), Irr.dot(xi)
    check(Pde.spmv_path == "dia-kernel" and Irr.spmv_path == "bsr",
          f"inline tenants took {Pde.spmv_path}, {Irr.spmv_path}")
    for M in (A1, A2, A3):
        M.dot(ones)
    rec["build_s"] = time.perf_counter() - t0
    sub = (A1, A2, A3, ones, Pde, xp, Irr, xi)
    obs.reset_all()
    obs.enable()
    try:
        # (a) The attributed load against the unattributed one, in turns
        # (spans on in both: the difference is attribution and SLOs).
        settings.gateway = True
        runs = {"off": [], "on": []}
        phase18_load(("banded", "blocks"), sub)     # warm-up, not kept
        y_off = None
        for _ in range(P18_REPEATS):
            for label in ("off", "on"):
                settings.obs_attrib = settings.obs_slo = label == "on"
                obs.reset_all()
                sync()
                reset_counts()
                ys, stages = phase18_load(("banded", "blocks"), sub)
                counts = read_counts()
                add(counts)
                check(counts["dia_spmv"] == 16 and counts["bsr_spmv"] == 16,
                      f"the load's inline launches {counts}")
                if y_off is None:
                    y_off = ys
                check(len(ys) == len(y_off), "served counts differ")
                for a, b in zip(ys, y_off):
                    bits(a, b, f"attribution {label}: a served y")
                wall = sum(s["wall_s"] for s in stages)
                served = sum(s["served"] for s in stages)
                run = {"requests_per_s": served / wall,
                       "p99_ms": max(s["p99_ms"] for s in stages),
                       "host_us_per_request": wall * 1e6 / served,
                       "stages": stages}
                if label == "on":
                    spans = sum(r["dur_ns"] for r in obs.records()
                                if r.get("type") == "span"
                                and r["name"] in attrib.DISPATCH_SPANS)
                    snap = obs.counters.snapshot("")
                    tw = sum(v for k, v in snap.items()
                             if k.startswith("attrib.tenant.")
                             and k.endswith(".wall_ns"))
                    tb = sum(v for k, v in snap.items()
                             if k.startswith("attrib.tenant.")
                             and k.endswith(".comm_bytes"))
                    check(spans > 0 and tw == spans
                          == snap.get("attrib.total.wall_ns"),
                          f"wall conservation: tenants {tw}, spans {spans}")
                    check(tb == snap.get("comm.total_bytes", 0) == 0,
                          f"byte conservation: tenants {tb}")
                    run["conservation"] = {"wall_ns": tw, "span_ns": spans,
                                           "comm_bytes": tb}
                    run["tenants"] = {t: v.get("wall_ns", 0) for t, v in
                                      attrib.tenant_snapshot().items()}
                else:
                    check(not obs.counters.snapshot("attrib."),
                          "attribution off moved attrib.* counters")
                runs[label].append(run)
        med = {lbl: {k: float(np.median([r[k] for r in runs[lbl]]))
                     for k in ("requests_per_s", "p99_ms",
                               "host_us_per_request")} for lbl in runs}

        # The host cost of one dispatch span's close, attribution off
        # and on (a one-member scope, as the inline tenants').
        def span_close_us(on):
            settings.obs_attrib = on
            obs.reset_all()
            with attrib.scope([("banded", "interactive")]):
                t0 = time.perf_counter_ns()
                for _ in range(P18_SPAN_CLOSES):
                    with obs.span("gateway.inline"):
                        pass
                dt = time.perf_counter_ns() - t0
            return dt / P18_SPAN_CLOSES / 1e3

        closes = {"off": [], "on": []}
        for _ in range(P18_REPEATS):
            for label in ("off", "on"):
                closes[label].append(span_close_us(label == "on"))
        close_med = {k: float(np.median(v)) for k, v in closes.items()}
        rec["attributed_load"] = {
            "runs": runs, "median": med,
            "throughput_share": (med["on"]["requests_per_s"]
                                 / med["off"]["requests_per_s"]),
            "added_host_us_per_request": (
                med["on"]["host_us_per_request"]
                - med["off"]["host_us_per_request"]),
            "span_close_us": close_med,
            "span_close_added_us": close_med["on"] - close_med["off"],
            "bitwise_on_off": True}

        # (b) SLOs and capacity over the last attributed load's ledger.
        settings.obs_attrib = settings.obs_slo = True
        obs.reset_all()
        ys, _st = phase18_load(("banded", "blocks"), sub)
        verdicts = slo.evaluate()
        check(len(verdicts) == len(slo.registered()),
              "a verdict per registered SLO")
        text = export.snapshot_openmetrics()
        parsed, _hists = export.parse_openmetrics(text)
        check('name="slo.evaluations"' in text
              and parsed.get("slo.evaluations") == 2,
              f"the scrape's slo.* counters: {parsed.get('slo.evaluations')}")
        for name, val in obs.counters.snapshot("").items():
            check(parsed.get(name) == val, f"scrape round trip: {name}")
        crep = capacity.capacity_report(devices=1)
        evs = [r for r in obs.records()
               if r["name"] == "capacity.recommendation"]
        check(crep is not None and len(evs) == 1
              and obs.counters.get("capacity.reports") == 1
              and evs[0]["attrs"]["devices"] == 1,
              f"capacity report {crep}, events {len(evs)}")
        rec["slo"] = {"verdicts": [
            {k: v for k, v in vv._asdict().items()
             if k in ("slo", "status", "fast_total", "fast_bad",
                      "fast_burn")} for vv in verdicts],
            "scrape_bytes": len(text)}
        rec["capacity"] = crep

        # (c) Placement on one card: the two kernel tenants placed,
        # served through the gateway, migrated, a controller step, the
        # drill with a mid-storm migration.
        settings.placement = True
        placement.place("banded", Pde)
        placement.place("blocks", Irr)
        c0 = obs.counters.snapshot("")
        reset_counts()
        gw = Gateway(Engine(), max_batch=8, queue_depth=128,
                     tenant_quota=64, rate=0.0, burst=16.0, slack_ms=5.0,
                     timeout_ms=0.0)
        try:
            yb = gw.submit(Pde, xp, tenant="banded").result(timeout=60)
            yk = gw.submit(Irr, xi, tenant="blocks").result(timeout=60)
        finally:
            gw.shutdown()
        counts = read_counts()
        add(counts)
        check(counts["dia_spmv"] == 1 and counts["bsr_spmv"] == 1,
              f"placed requests' launches {counts}")
        bits(yb, yp_ref, "placed banded tenant vs A.dot")
        bits(yk, yi_ref, "placed blocks tenant vs A.dot")
        check(moved(c0, "placement.routes") == 2,
              "placement.routes must move twice")
        migr = {}
        reg = placement.registry()
        for name, M, x, ref in (("banded", Pde, xp, yp_ref),
                                ("blocks", Irr, xi, yi_ref)):
            h0 = placement.route(M, name)
            c0 = obs.counters.snapshot("")
            moved_b = placement.migrate_to(name, 1)
            priced = psub.priced_bytes(psub.price_migration(
                reg.payload_bytes()[name], 1))
            check(moved_b == priced == moved(
                c0, "comm.dist_reshard.ppermute_bytes")
                == moved(c0, "placement.migration.bytes"),
                f"{name}: recorded {moved_b} bytes, priced {priced}")
            h1 = placement.route(M, name)
            check(h0.version == 0 and h1.version == 1
                  and reg.slices()[name] == (0, 1),
                  f"{name}: versions {h0.version} -> {h1.version}")
            reset_counts()
            bits(h1.dot(x), ref, f"{name} after the migration")
            bits(h0.dot(x), ref, f"{name}'s drained handle")
            add(read_counts())
            migr[name] = {"priced_bytes": priced, "recorded_bytes": moved_b,
                          "payload_bytes": reg.payload_bytes()[name]}
        hist = obs.latency.get("lat.placement.migration")
        check(hist is not None and hist.count == 2,
              "lat.placement.migration")
        migr["lat_ms"] = {"count": hist.count, "mean": hist.mean,
                          "max": hist.max()}
        rec["migration"] = migr
        ctl = placement.PlacementController(devices=[0])
        decision = ctl.step()
        check(decision is not None
              and obs.counters.get("placement.steps") == 1,
              f"controller step {decision}")
        rec["controller"] = {
            "act": decision.act, "reason": decision.reason,
            "allocation": decision.allocation,
            "total_priced_bytes": decision.total_priced_bytes,
            "step_ms": obs.latency.get("lat.placement.step").max()}
        placement.reset()

        settings.resil = True
        settings.resil_backoff_ms = 0.0
        resilience.reset()

        def xs(m, k):
            return [randx(m) for _ in range(k)]

        tenants = [
            {"name": "a1", "qos": "interactive", "A": A1, "xs": xs(n, 2)},
            {"name": "background", "qos": "background", "A": A2,
             "xs": xs(n, 2), "deadline_ms": 0.0},
            {"name": "banded", "qos": "interactive", "A": Pde,
             "xs": xs(Pde.shape[1], 2)},
            {"name": "blocks", "qos": "interactive", "A": Irr,
             "xs": xs(P16_IRR_ROWS, 2)}]
        gw = Gateway(Engine(), max_batch=8, queue_depth=128,
                     tenant_quota=64, rate=0.0, burst=16.0, slack_ms=5.0,
                     timeout_ms=0.0)
        try:
            report, drill_counts, _ms, drill_s = counted_run(
                lambda: chaos.run_drill(
                    gw, tenants, rounds=4, seed=7,
                    migration={"tenant": "banded", "devices": (1, 1)}))
        finally:
            gw.shutdown()
            resilience.reset()
            placement.reset()
        add(drill_counts)
        check(report.ok(), f"chaos drill violations {report.violations}")
        for name, t in report.per_tenant.items():
            check(t["submitted"] == t["served"] + t["shed"] + t["error"],
                  f"tenant {name} ledger {t}")
            if name != "background":
                check(t["served"] == t["submitted"] == 8,
                      f"good tenant {name} lost requests: {t}")
        check(report.migrations == 2 and report.submitted == 32,
              f"drill report {report}")
        check(drill_counts["dia_spmv"] > 0 and drill_counts["bsr_spmv"] > 0,
              f"the drill's launches {drill_counts}")
        rec["chaos"] = {"rounds": report.rounds, "seed": 7,
                        "submitted": report.submitted,
                        "served": report.served, "shed": report.shed,
                        "migrations": report.migrations,
                        "faults_fired": report.faults_fired,
                        "per_tenant": report.per_tenant,
                        "launches": {k: v for k, v in drill_counts.items()
                                     if v},
                        "host_s": drill_s}

        # (e) The doctor over this phase's artifacts, in a subprocess.
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "phase18")
        os.makedirs(out_dir, exist_ok=True)
        trace_path = os.path.join(out_dir, "operations.trace.json")
        prom_path = os.path.join(out_dir, "operations.prom")
        obs.write_chrome_trace(trace_path)
        export.write_openmetrics(prom_path)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        res = subprocess.run(
            [sys.executable, "-m", "legate_sparse_tpu_torch.obs.doctor",
             "--check", "--json", trace_path, prom_path],
            capture_output=True, text=True, env=env, timeout=120)
        check(res.returncode in (0, 1),
              f"doctor exit {res.returncode}: {res.stderr[-2000:]}")
        findings = json.loads(res.stdout)
        rec["doctor"] = {"exit": res.returncode,
                         "read": res.stderr.strip().splitlines(),
                         "findings": [{k: f[k] for k in ("severity", "code",
                                                          "value")}
                                      for f in findings]}
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        obs.disable()
        obs.reset_all()
        placement.reset()
        resilience.reset()
    check(launches["dia_spmv"] > 0 and launches["bsr_spmv"] > 0,
          f"phase 18 launches {launches}")
    del A1, A2, A3, Pde, Irr, sub, tenants
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, launches


def phase18_submesh_rank(rank, world):
    """Phase 18 (d) on ``world`` NCCL ranks (one a card): pde_4096
    placed and migrated onto ranks 0-1; the slice's ranks serve through
    ``dist_spmv`` (the DIA kernel on each window) bit for bit the
    one-card product, and a rank outside the slice serves its local
    product with no collective."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import placement

    dev = torch.device("cuda", torch.cuda.current_device())
    Pd, offsets = pde_diagonals(P16_GRID)
    A = sparse.diags(Pd, offsets, shape=(P16_GRID ** 2,) * 2, format="csr",
                     dtype=np.float32, device=dev)
    x = torch.randn(A.shape[1], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(18))
    ref = A.dot(x)
    placement.place("banded", A)
    moved_b = placement.migrate_to("banded", 2)
    h = placement.route(A, "banded")
    calls = [0]
    patched = []
    for mod, names in ((dist, ("all_reduce", "all_gather",
                               "all_gather_into_tensor", "broadcast",
                               "batch_isend_irecv", "all_to_all_single",
                               "barrier", "send", "recv")),
                       (funcol, ("all_gather_tensor", "all_reduce",
                                 "reduce_scatter_tensor"))):
        for name in names:
            real = getattr(mod, name, None)
            if real is None:
                continue

            def counted(*a, _real=real, **k):
                calls[0] += 1
                return _real(*a, **k)

            patched.append((mod, name, real))
            setattr(mod, name, counted)
    d0 = kernel_counters()["dia_spmv"].launches
    try:
        y = h.dot(x)
        sync()
    finally:
        for mod, name, real in patched:
            setattr(mod, name, real)
    out = {"rank": rank, "member": h._dist is not None,
           "collectives": calls[0], "bitwise": bool(torch.equal(y, ref)),
           "dia_spmv": kernel_counters()["dia_spmv"].launches - d0,
           "migration_bytes": moved_b}
    placement.reset()
    dist.barrier()
    return out


# Phase 19's widths: the SpMV microbenchmark's rows (BASELINE config 2),
# the SpGEMM microbenchmark's (config 5), the spectral app's second n,
# the pde app's grid (unknowns per side) and the GMG app's.
P19_SPMV_ROWS, P19_SPGEMM_ROWS, P19_SPECTRAL_N, P19_PDE_GRID, P19_GMG_GRID = (
    1 << 24, 1 << 24, 40_000, 4096, 512)


def phase19_dist_rank(rank, world):
    """Phase 19 (a)'s banded distributed inputs on one NCCL rank: the
    dist phase's band (``bench_torch.FULL["dist_log2_rows"]``) and the
    attribution phase's (``["serve_rows"]``), row-sharded as the bench
    shards them; each ``dist_spmv`` on a seeded x goes through the DIA
    kernel on the rank's window (one launch), bit for bit the plain DIA
    SpMV on that window (offset order, f32 accumulator) and the
    single-device ``A @ x``.  Returns the comparisons."""
    import torch

    import bench_torch
    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import parallel as P
    from legate_sparse_tpu_torch.ops import dia_kernel
    from legate_sparse_tpu_torch.parallel import dist_csr as D

    mesh = P.make_row_mesh()
    group = mesh.get_group("rows")
    dev = D.mesh_device(mesh)
    gen = torch.Generator(device=dev).manual_seed(19)
    out = {}
    full = bench_torch.FULL
    for name, n in (("bench dist_spmv", 1 << full["dist_log2_rows"]),
                    ("bench attrib dist_spmv", full["serve_rows"])):
        A = bench_torch._banded_config(sparse, n, bench_torch.NNZ_PER_ROW,
                                       device=dev)
        dA = P.shard_csr(A, mesh=mesh)
        x = torch.rand(n, generator=gen, device=dev) * 2 - 1
        xs = D.shard_vector(x, mesh, dA.rows_padded)
        sync()
        reset_counts()
        y = P.dist_spmv(dA, xs).to_local()
        sync()
        counts = read_counts()
        check(dA.spmv_path == "dia-kernel" and counts["dia_spmv"] == 1
              and sum(counts.values()) == 1,
              f"{name}: {dA.spmv_path}, launches {counts}")
        pk = dA.dia_pack
        xw = D._extend_x(x, dA.halo, group)
        yp = dia_kernel.dia_spmv_plain(pk.rdata, pk.rmask, xw, pk.offsets,
                                       pk.shape)
        err = close(y, yp, 1e-6, f"{name} vs plain")
        check(torch.equal(y, yp), f"{name}: the kernel on the window is not "
              "bit for bit the plain DIA SpMV")
        check(torch.equal(y, A @ x), f"{name}: not bit for bit the "
              "single-device A @ x")
        out[name] = {"kernel": "dia_spmv", "rows": n, "diagonals": len(
            pk.offsets), "halo": dA.halo, "max_abs_err": err,
            "bitwise": True}
        del A, dA, x, xs, y, yp, xw, pk
    return out


def phase19_entry_points():
    """Phase 19 (``main_path_entry_points``): the port's entry points at
    full width, in this process (the distributed runs on one NCCL rank
    each): (a) ``bench_torch.main()``, (b) the SpMV microbenchmark, (c)
    the SpGEMM microbenchmark, stable and fresh, (d) the spectral app,
    (e) the pde app's explicit, throughput and distributed modes and the
    GMG app on the diffusion operator.  The launches are counted over
    the runs alone; the comparisons with the plain versions (also of
    the bench's BSR, bf16 and SpGEMM inputs, rebuilt) and scipy come
    after.  Returns ``(record, launches, kernel_vs_plain)``; any failed
    check raises."""
    import math

    import numpy as np
    import torch

    import bench_torch
    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import eigen as eigen_mod
    from legate_sparse_tpu_torch.apps import common as app_common
    from legate_sparse_tpu_torch.apps import gmg as gmg_app
    from legate_sparse_tpu_torch.apps import pde
    from legate_sparse_tpu_torch.apps import spectral
    from legate_sparse_tpu_torch.apps import spgemm_microbenchmark as spgemm_mb
    from legate_sparse_tpu_torch.apps import spmv_microbenchmark as spmv_mb
    from legate_sparse_tpu_torch.ops import bsr as bsr_ops
    from legate_sparse_tpu_torch.ops import dia_kernel

    rec = {}
    seconds = {}
    f32 = torch.float32

    def lap(name, t0):
        seconds[name] = time.perf_counter() - t0

    reset_counts()
    # (a) the bench at its full sizes.
    t0 = time.perf_counter()
    bench = bench_torch.main([])
    lap("bench", t0)
    for key in bench_torch.HEADLINE_NUMBERS:
        val = bench.get(key)
        log({"phase": "entry_bench_field", "field": key, "value": val})
        check(isinstance(val, (int, float)) and math.isfinite(val),
              f"bench_torch: {key} = {val!r}")
    for key in bench_torch.HEADLINE_STRINGS:
        log({"phase": "entry_bench_field", "field": key,
             "value": bench.get(key)})
        check(isinstance(bench.get(key), str), f"bench_torch: {key}")
    check(bench["vs_baseline"] <= 1.05,
          f"bench_torch: vs_baseline {bench['vs_baseline']} > 1.05")
    check(bench["value"] <= 1.05 * HBM_BYTES_PER_S / 1e9,
          f"bench_torch: value {bench['value']} GB/s past the HBM peak")
    check(bench["path"] == "dia", f"bench_torch: path {bench['path']}")
    check(bench["pde_roofline_ratio"] <= 1.05,
          f"bench_torch: pde_roofline_ratio {bench['pde_roofline_ratio']}")
    # The twelve phases ported from bench.py: every field; on one card
    # the recovery drill is gated off; the counts that depend neither on
    # the rank count nor on the sizes equal the JAX golden's.
    cards = torch.cuda.device_count()
    recovery = bench_torch.PHASE_NUMBERS["recovery"]
    for phase, keys in bench_torch.PHASE_NUMBERS.items():
        for key in keys:
            val = bench.get(key)
            log({"phase": "entry_bench_field", "field": key, "value": val})
            if phase == "recovery" and cards < 2:
                check(val is None, f"bench_torch: {key} on one card")
                continue
            check(isinstance(val, (int, float)) and math.isfinite(val),
                  f"bench_torch: {key} = {val!r}")
    for key in bench_torch.PHASE_STRINGS:
        log({"phase": "entry_bench_field", "field": key,
             "value": bench.get(key)})
        check(isinstance(bench.get(key), str), f"bench_torch: {key}")
    check(bench["schema_version"] == 20 and bench["dist_shards"] == cards,
          f"bench_torch: schema {bench['schema_version']}, "
          f"{bench['dist_shards']} shards on {cards} cards")
    check(cards >= 2 or not any(k in bench for k in recovery),
          "bench_torch: recovery fields on one card")
    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "evidence", "BENCH_golden_smoke.json")
    with open(golden_path) as f:
        golden = json.load(f)
    as_golden = ("engine_plan_hits", "engine_plan_misses",
                 "engine_batch_requests", "resil_retries", "resil_shed",
                 "resil_breaker_trips", "resil_faults_injected",
                 "gateway_requests", "gateway_dispatches", "gateway_packed",
                 "gateway_rejected_queue_full",
                 "gateway_interactive_served", "gateway_interactive_shed",
                 "gateway_batch_served", "gateway_background_served",
                 "gateway_background_shed", "saturation_shed",
                 "attrib_requests", "attrib_packed", "autotune_verdicts",
                 "graph_pagerank_iters")
    for key in as_golden:
        check(bench[key] == golden[key], f"bench_torch: {key} "
              f"{bench[key]} != the golden's {golden[key]}")
    # Conserved means equal and above 0: one card sends no bytes.
    check(bench["attrib_tenant_comm_bytes"] == bench["attrib_comm_bytes"]
          and bench["attrib_conserved"] == int(cards > 1),
          f"bench_torch: attrib {bench['attrib_tenant_comm_bytes']} tenant "
          f"bytes of {bench['attrib_comm_bytes']}, conserved "
          f"{bench['attrib_conserved']}")
    full = bench_torch.FULL
    offered = sum(full["saturation_levels"]) * full["saturation_per_client"]
    check(bench["saturation_requests"] == offered
          == bench["saturation_batched_requests"],
          f"bench_torch: saturation {bench['saturation_requests']} resolved, "
          f"{bench['saturation_batched_requests']} batched of {offered}")
    check(bench["dist_cg_iters"] == bench["dist2d_cg_iters"]
          == full["dist_cg_iters"], f"bench_torch: dist_cg ran "
          f"{bench['dist_cg_iters']}, {bench['dist2d_cg_iters']} iterations")
    rec["bench"] = bench

    h = app_common.parse_common_args(["--dtype", "float32"])
    # (b) the SpMV microbenchmark (BASELINE config 2), into a fresh y and
    # into a preallocated one.
    t0 = time.perf_counter()
    A = app_common.banded_matrix(P19_SPMV_ROWS, 11, device=h.device,
                                 dtype=h.dtype)
    spmv = spmv_mb.run_spmv(A, 20, False, h, False)
    spmv_out = spmv_mb.run_spmv(A, 20, False, h, True)
    lap("spmv_microbenchmark", t0)
    # (c) the SpGEMM microbenchmark (BASELINE config 5), stable and fresh.
    t0 = time.perf_counter()
    gemm_stable = spgemm_mb.run_spgemm(P19_SPGEMM_ROWS, 5, "", "", 10, True, h)
    gemm_fresh = spgemm_mb.run_spgemm(P19_SPGEMM_ROWS, 5, "", "", 1, False,
                                      h)
    lap("spgemm_microbenchmark", t0)
    # (e) the pde app's modes on the 4096^2 grid, the GMG app on diffusion.
    g = P19_PDE_GRID + 2
    t0 = time.perf_counter()
    expl = pde.explicit(g, g, 500, 50, dtype=f32, device=h.device)
    lap("pde_explicit", t0)
    t0 = time.perf_counter()
    # rtol 0: a fixed 450 timed iterations on both sides.
    thr = pde.throughput(g, g, 0.0, 500, 50, dtype=f32, device=h.device)
    lap("pde_throughput", t0)
    t0 = time.perf_counter()
    dist = pde.distributed(g, g, True, 0.0, 500, 50, dtype=f32,
                           device=h.device, ranks=1, return_x=True)
    lap("pde_distributed", t0)
    t0 = time.perf_counter()
    diff = gmg_app.solve(P19_GMG_GRID, 6, gridop="linear", tol=1e-5,
                         dtype=f32, device=h.device, data="diffusion",
                         warmup=True)
    lap("gmg_diffusion", t0)
    launches = read_counts()
    # The bench's ranks count their launches in their own processes: the
    # GMG phase's and each distributed phase's.
    per_phase = bench["rank_kernel_launches"]
    rec["bench_rank_launches"] = per_phase
    launches = {k: v + sum(p[k] for p in per_phase.values())
                for k, v in launches.items()}
    check(all(launches[k] > 0 for k in ("dia_spmv", "bsr_spmv",
                                        "dia_spgemm")),
          f"phase 19 launches {launches}")
    # The dist phase: at least its warm-up product, its timing loop's
    # three runs at each trip count, and dist_cg's iterations and first
    # residual; the attribution phase: its two products.
    least = 1 + 3 * (2 + full["dist_k_hi"]) + full["dist_cg_iters"] + 1
    check(per_phase["dist"]["dia_spmv"] >= least
          and per_phase["attrib"]["dia_spmv"] == 2,
          f"phase 19: the bench's ranks launched {per_phase}; the dist "
          f"phase's dia_spmv under {least}, or attrib's not 2")

    # The kernels of (b) and (c) against their plain versions.
    kernel_vs_plain = {}
    ones = torch.ones(A.shape[1], dtype=f32, device=h.device)
    packed = A._get_dia_pack()
    yp = dia_kernel.dia_spmv_plain(packed.rdata, packed.rmask, ones,
                                   packed.offsets, packed.shape)
    check(A.spmv_path == "dia-kernel", f"spmv microbenchmark took "
          f"{A.spmv_path}")
    for name, r in (("spmv_microbenchmark", spmv),
                    ("spmv_microbenchmark --use-out", spmv_out)):
        check(torch.equal(r["y"], yp), f"{name}: not bitwise the plain "
              "DIA SpMV")
        kernel_vs_plain[name] = {"kernel": "dia_spmv", "max_abs_err": 0.0}
    rec["spmv_microbenchmark"] = {
        "rows": spmv["rows"], "nnz": spmv["nnz"], "path": A.spmv_path,
        "ms_per_iter": spmv["ms_per_iter"],
        "use_out_ms_per_iter": spmv_out["ms_per_iter"],
        "gbs": A.spmv_traffic_bytes(ones) / (spmv["ms_per_iter"] * 1e-3)
        / 1e9, "bitwise_vs_plain": True}
    del A, packed, yp, spmv, spmv_out, ones
    for name, r in (("stable", gemm_stable), ("fresh", gemm_fresh)):
        check(r["path"] == "dia-kernel",
              f"spgemm microbenchmark ({name}) took {r['path']}")
        da, db = r["A"]._get_dia(), r["B"]._get_dia()
        Cd, offs_c, _mask = r["C"]._dia
        Cp = dia_kernel.dia_spgemm_plain(da[0], db[0], da[1], db[1], offs_c,
                                         r["A"].shape, r["B"].shape)
        check(torch.equal(Cd, Cp), f"spgemm microbenchmark ({name}): not "
              "bitwise the plain DIA SpGEMM")
        kernel_vs_plain[f"spgemm_microbenchmark {name}"] = {
            "kernel": "dia_spgemm", "max_abs_err": 0.0}
        rec[f"spgemm_microbenchmark_{name}"] = {
            "rows": P19_SPGEMM_ROWS, "nnz_c": r["C"].nnz,
            "ms_per_iter": r["ms_per_iter"], "path": r["path"],
            "bitwise_vs_plain": True}
    del gemm_stable, gemm_fresh, da, db, Cd, Cp

    # The inputs (a) gave the kernels beyond (b)'s and (c)'s shapes,
    # rebuilt at the bench's sizes: its BSR matrix, its bf16 band and its
    # SpGEMM band, each against the kernel's plain version on a seeded x.
    gen = torch.Generator(device=h.device).manual_seed(19)

    def seeded_x(n, dtype):
        return (torch.rand(n, generator=gen, device=h.device) * 2 - 1).to(
            dtype)

    bench_vs_plain = {}
    A_b, st = bench_torch._bsr_config(sparse, full["bsr_rows"], h.device)
    xb = seeded_x(st.nbc * 128, f32)
    yb = st.matvec(xb[:A_b.shape[1]])
    ybp = bsr_ops.bsr_spmv_plain(st, xb.reshape(-1, 128)).reshape(-1)[
        :A_b.shape[0]]
    bench_vs_plain["bench bsr"] = {
        "kernel": "bsr_spmv", "rows": A_b.shape[0], "nnz": A_b.nnz,
        "blocks": st.nblocks,
        "max_abs_err": close(yb, ybp, 1e-5, "bench bsr vs plain")}
    del A_b, st, xb, yb, ybp
    A16 = bench_torch._banded_config(sparse, 1 << full["log2_rows"], 11,
                                     dtype=torch.bfloat16, device=h.device)
    x16 = seeded_x(A16.shape[1], torch.bfloat16)
    y16 = A16 @ x16
    check(A16.spmv_path == "dia-kernel", f"bench bf16 took {A16.spmv_path}")
    pk = A16._get_dia_pack()
    y16p = dia_kernel.dia_spmv_plain(pk.rdata, pk.rmask, x16, pk.offsets,
                                     pk.shape)
    check(torch.equal(y16, y16p), "bench bf16: not bitwise the plain DIA "
          "SpMV")
    bench_vs_plain["bench bf16"] = {
        "kernel": "dia_spmv", "rows": A16.shape[0], "diagonals": 11,
        "max_abs_err": max_abs(y16, y16p), "bitwise": True}
    del A16, x16, y16, y16p, pk
    A_gm = bench_torch._banded_config(sparse, full["spgemm_rows"], 11,
                                      device=h.device)
    C_gm = A_gm @ A_gm
    check(A_gm.spgemm_path == "dia-kernel",
          f"bench spgemm took {A_gm.spgemm_path}")
    dg = A_gm._get_dia()
    Cd, offs_c, _mask = C_gm._dia
    Cp = dia_kernel.dia_spgemm_plain(dg[0], dg[0], dg[1], dg[1], offs_c,
                                     A_gm.shape, A_gm.shape)
    check(torch.equal(Cd, Cp), "bench spgemm: not bitwise the plain DIA "
          "SpGEMM")
    bench_vs_plain["bench spgemm"] = {
        "kernel": "dia_spgemm", "rows": A_gm.shape[0],
        "diagonals_c": len(offs_c), "max_abs_err": 0.0, "bitwise": True}
    del A_gm, C_gm, dg, Cd, Cp
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench_vs_plain.update(run_ranks(phase19_dist_rank, 1, backend="nccl",
                                    timeout=600, init_timeout=120)[0])
    lap("bench_dist_inputs", t0)
    kernel_vs_plain.update(bench_vs_plain)
    rec["bench_inputs_vs_plain"] = bench_vs_plain

    # (d) the spectral app against host scipy, with the eigensolvers'
    # scipy fallback replaced by one that raises.
    real_fallback = eigen_mod._host_fallback

    def no_fallback(name):
        raise RuntimeError(f"phase 19: eigen fell back to scipy ({name})")

    h_cpu = app_common.parse_common_args(["--package", "scipy"])
    for n in (4000, P19_SPECTRAL_N):
        t0 = time.perf_counter()
        eigen_mod._host_fallback = no_fallback
        try:
            got = spectral.run(h, n, 4, 6)
        finally:
            eigen_mod._host_fallback = real_fallback
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = spectral.run(h_cpu, n, 4, 6)
        host_s = time.perf_counter() - t0
        check(got["components"] == ref["components"]
              and np.array_equal(got["labels"], ref["labels"]),
              f"spectral n={n}: components differ from scipy's")
        err = float(np.abs(got["eigenvalues"] - ref["eigenvalues"]).max())
        check(err <= 1e-8, f"spectral n={n}: eigenvalues {err} from scipy's")
        rec[f"spectral_{n}"] = {
            "nnz": got["nnz"], "components": got["components"],
            "eigenvalues": got["eigenvalues"].tolist(),
            "max_abs_err_vs_scipy": err, "near_zero": got["near_zero"],
            "gap": got["gap"], "card_ms": {
                k: got[k] for k in ("cc_ms", "laplacian_ms", "eigsh_ms")},
            "scipy_ms": {k: ref[k] for k in ("cc_ms", "laplacian_ms",
                                              "eigsh_ms")},
            "card_s": card_s, "host_s": host_s,
            "laplacian_path": got["laplacian_path"]}
        seconds[f"spectral_{n}"] = card_s + host_s

    # (e)'s results.
    for name, r in (("explicit", expl), ("throughput", thr)):
        check(r["path"] == "dia-kernel", f"pde {name} took {r['path']}")
        check(bool(torch.isfinite(r["x"]).all()), f"pde {name}: not finite")
    check(thr["iters"] == 450, f"pde throughput: {thr['iters']} iterations")
    x_single = thr.pop("x").cpu().numpy()
    x_dist = dist.pop("x")
    check(dist["iters"] == thr["iters"] and dist["spmv_path"] == "dia-kernel",
          f"pde distributed: {dist['iters']} iterations on "
          f"{dist['spmv_path']}")
    dist_err = float(np.abs(x_dist - x_single).max()
                     / max(np.abs(x_single).max(), 1e-30))
    check(dist_err <= 1e-5, f"pde distributed: x {dist_err} from the "
          "single-device solve")
    expl.pop("x")
    check(diff["converged"] or diff["rel_residual"] <= 2 * max(
        diff["residual_floor"], 1e-5), f"gmg diffusion: {diff['rel_residual']}")
    diff.pop("x")
    diff.pop("gmg")
    rec["pde_explicit"] = expl
    rec["pde_throughput"] = thr
    rec["pde_distributed"] = {**dist, "x_rel_err_vs_single": dist_err,
                              "bitwise_vs_single": bool(dist_err == 0.0)}
    rec["gmg_diffusion"] = diff
    rec["seconds"] = seconds
    return rec, launches, kernel_vs_plain


def phase20_tools(bench: dict, smi_line: str):
    """Phase 20 (``main_path_tools``): the port's three tools on the
    card.  (a) ``tools.tune_irregular`` at the JAX tool's sizes
    (``FULL``), its launches counted over the run alone (``bsr_spmv``
    only, as many as its configs that pack report), then on every
    config that packs ``bsr_spmv`` against ``bsr_spmv_plain`` (1e-5) on
    a seeded x; (b) ``bench_torch.py --smoke`` on the card, traced: the
    trace that (d) reads, kept apart from phase 19's timed bench; (c)
    ``tools.bench_compare`` on phase 19's bench JSON against itself
    (exit 0) and against a copy with ``spmv_ms`` doubled (exit 1); (d)
    ``tools.trace_summary --comm --autotune --gateway --latency`` over
    (b)'s trace (exit 0, every table with rows).  (c) and (d) call the
    tools' ``main``, their ``python -m`` entry points, in this process.
    Its launches are (a)'s and (b)'s.
    Returns ``(record, launches, kernel_vs_plain)``; any failed check
    raises."""
    import torch

    import bench_torch
    from legate_sparse_tpu_torch import obs
    from legate_sparse_tpu_torch.ops import bsr as bsr_ops
    from legate_sparse_tpu_torch.tools import (bench_compare, trace_summary,
                                               tune_irregular)

    rec, seconds = {}, {}
    t_phase = time.perf_counter()
    art_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase20")
    os.makedirs(art_dir, exist_ok=True)

    # (a) the shoot-out.
    keep = []
    reset_counts()
    t0 = time.perf_counter()
    shoot = tune_irregular.run(tune_irregular.FULL, "cuda", keep=keep)
    seconds["tune_irregular"] = time.perf_counter() - t0
    launches = read_counts()
    packed = [c for c in shoot["configs"] if "nblocks" in c]
    check([c["label"] for c in packed] == [label for label, _ in keep]
          and all(c["bsr_launches"] > 0 for c in packed)
          and launches["bsr_spmv"] == sum(c["bsr_launches"] for c in packed)
          and all(n == 0 for k, n in launches.items() if k != "bsr_spmv"),
          f"phase 20: shoot-out launches {launches}, per config "
          f"{[(c['label'], c['bsr_launches']) for c in packed]}")
    for cfg in shoot["configs"]:
        log({"phase": "tools_shootout_config", "nvidia_smi": smi_line,
             **cfg})
    gen = torch.Generator(device="cuda").manual_seed(20)
    vs_plain = {}
    for label, st in keep:
        x2d = torch.rand((st.nbc, 128), generator=gen, device="cuda") * 2 - 1
        y = bsr_ops.bsr_spmv(st, x2d)
        yp = bsr_ops.bsr_spmv_plain(st, x2d)
        vs_plain[f"shootout {label}"] = {
            "kernel": "bsr_spmv", "rows": st.rows, "blocks": st.nblocks,
            "max_abs_err": close(y, yp, 1e-5, f"shootout {label} vs plain")}
        del x2d, y, yp
    del keep
    torch.cuda.empty_cache()
    rec["shootout"] = {k: shoot[k] for k in ("platform", "platform_fp",
                                             "verdicts")}
    rec["shootout"]["packed"] = [c["label"] for c in packed]
    rec["shootout_launches"] = dict(launches)

    # (b) the traced smoke bench (its LEGATE_SPARSE_TPU_OBS=1 mode).
    trace_path = os.path.join(art_dir, "bench_smoke.trace.json")
    os.environ["LEGATE_SPARSE_TPU_OBS_FILE"] = trace_path
    obs.reset_all()
    obs.enable()
    reset_counts()
    t0 = time.perf_counter()
    try:
        smoke = bench_torch.main(["--smoke"])
    finally:
        obs.disable()
        obs.reset_all()
        del os.environ["LEGATE_SPARSE_TPU_OBS_FILE"]
    seconds["bench_smoke_traced"] = time.perf_counter() - t0
    smoke_launches = read_counts()
    check(smoke["trace_file"] == trace_path and smoke["trace_spans"] > 0,
          f"bench_torch --smoke: trace {smoke.get('trace_file')}, "
          f"{smoke.get('trace_spans')} spans")
    launches = {k: n + smoke_launches[k] for k, n in launches.items()}
    rec["bench_smoke"] = {"trace_spans": smoke["trace_spans"],
                          "launches": smoke_launches}

    def tool(run, module, *args):
        """(exit code, stdout, stderr) of ``module.main(args)``: the
        ``python -m`` entry point, in this process."""
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = module.main(list(args))
        seconds[run] = time.perf_counter() - t0
        return rc, out.getvalue(), err.getvalue()

    # (c) bench_compare on phase 19's bench.
    bench_path = os.path.join(art_dir, "bench.json")
    with open(bench_path, "w") as f:
        f.write(json.dumps(bench) + "\n")
    doubled = os.path.join(art_dir, "bench_doubled.json")
    with open(doubled, "w") as f:
        f.write(json.dumps(dict(bench, spmv_ms=2 * bench["spmv_ms"])) + "\n")
    rc, same_out, same_err = tool("bench_compare_self", bench_compare,
                                  bench_path, bench_path)
    check(rc == 0 and "clean: no out-of-band regressions" in same_out,
          f"bench_compare on itself: exit {rc}: {same_err[-2000:]}")
    rc2, _, worse_err = tool("bench_compare_doubled", bench_compare,
                             bench_path, doubled)
    check(rc2 == 1 and "REGRESSED" in worse_err and "spmv_ms" in worse_err,
          f"bench_compare, spmv_ms doubled: exit {rc2}: {worse_err[-2000:]}")
    rec["bench_compare"] = {
        "self_exit": rc, "doubled_exit": rc2,
        "doubled_regressed": worse_err.strip().splitlines()[-1],
        "gated_rows": len(same_out.splitlines())}

    # (d) trace_summary over (b)'s trace.
    rc, text, err = tool("trace_summary", trace_summary, trace_path,
                         "--comm", "--autotune", "--gateway", "--latency")
    check(rc == 0, f"trace_summary: exit {rc}: {err[-2000:]}")
    tables = {}
    for head in ("comm ledger:", "autotune ledger:", "gateway ledger:",
                 "latency histograms:"):
        check(head in text, f"trace_summary: no {head!r}")
        body = text.split(head, 1)[1].lstrip("\n").split("\n\n", 1)[0]
        lines = body.splitlines()
        check(len(lines) > 2 and not body.startswith("no "),
              f"trace_summary: {head} {body[:200]!r}")
        tables[head.rstrip(":")] = lines
    rec["trace_summary"] = {
        "op_rows": len(text.split("\n\n", 1)[0].splitlines()) - 2,
        "tables": {k: len(v) - 2 for k, v in tables.items()},
        "comm": tables["comm ledger"], "autotune": tables["autotune ledger"]}
    log({"phase": "tools_trace_summary", "stdout": text[-20000:]})
    rec["seconds"] = dict(seconds, total=time.perf_counter() - t_phase)
    return rec, launches, vs_plain


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    import numpy as np
    import scipy.sparse as sp
    from scipy import fft

    import legate_sparse_tpu_torch as sparse
    from legate_sparse_tpu_torch import linalg, utils_native
    from legate_sparse_tpu_torch.apps import gmg as gmg_app
    from legate_sparse_tpu_torch.apps import pde
    from legate_sparse_tpu_torch.ops import _build
    from legate_sparse_tpu_torch.ops import bsr as bsr_ops
    from legate_sparse_tpu_torch.ops import dia_kernel
    from legate_sparse_tpu_torch.ops import dia_ops
    from legate_sparse_tpu_torch.ops import csr_kernel
    from legate_sparse_tpu_torch.ops import ell_kernel
    from legate_sparse_tpu_torch.ops import spmv as spmv_ops

    warnings.filterwarnings(
        "ignore", message="Sparse (CSR tensor support|invariant checks)")
    # Plain versions run float32 products in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log({"phase": "device", "kind": kind,
         "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
         "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in _build.LOGS.items()}
    log({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    counters = kernel_counters()
    # Every csr-rowids product from here on, counted against the CSR
    # kernel's launches phase by phase; the kernel's checks against its
    # twin and the plain ops, at each shape that takes it.
    csr_phases = CsrLaunches()
    csr_held = []

    def bound(nbytes: float, nops: float) -> dict:
        """``bound_ms`` and ``bound_by`` of a kernel moving ``nbytes``
        and doing ``nops`` f32 operations."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
        return {"bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def dia_case(name, A, x, bitwise):
        packed = A._get_dia_pack()
        check(packed is not None, f"{name}: the DIA kernel must take it")
        y = dia_kernel.dia_spmv(packed, x)
        yp = dia_kernel.dia_spmv_plain(packed.rdata, packed.rmask, x,
                                       packed.offsets, packed.shape)
        err = close(y, yp, 1e-6, name)
        if bitwise:
            check(torch.equal(y, yp), f"{name}: not bitwise equal")
        return {"case": name, "rows": packed.shape[0],
                "cols": packed.shape[1], "offsets": list(packed.offsets),
                "dtype": str(x.dtype), "masked": packed.rmask is not None,
                "max_abs_err": err, "bitwise": bool(torch.equal(y, yp))}

    rng = np.random.default_rng(0)

    def band(n, m, offsets, dtype):
        diagonals = [rng.standard_normal(
            min(n + min(o, 0), m - max(o, 0))).astype(np.float32)
            for o in offsets]
        return sparse.diags(diagonals, offsets, shape=(n, m), format="csr",
                            dtype=dtype)

    def randx(n, dtype=torch.float32):
        return torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)).to(dev, dtype)

    def randX(n, k, dtype=torch.float32):
        return torch.from_numpy(
            rng.standard_normal((n, k)).astype(np.float32)).to(dev, dtype)

    # ---- 3. kernels against their plain versions ---------------------------
    cases = []
    n = 1 << 20
    cases.append(dia_case("f32-exact", band(n, n, [-2, -1, 0, 1, 2],
                                            torch.float32), randx(n), True))
    # Holey band whose columns in S are stored only at holes, and x
    # columns past the band's reach: inf/NaN there must not reach y.
    m = n + 64
    main_d = rng.standard_normal(n).astype(np.float32)
    off2 = rng.standard_normal(n).astype(np.float32)
    S = np.arange(10, n, 1000)
    main_d[S] = 0.0
    off2[S - 2] = 0.0
    H = sparse.diags([main_d, off2], [0, 2], shape=(n, m), format="csr",
                     dtype=torch.float32)
    check(H._get_dia() is not None and H._get_dia()[2] is not None,
          "holey case must carry a hole mask")
    xh = randx(m)
    xh[torch.as_tensor(S[::2], device=dev)] = float("inf")
    xh[torch.as_tensor(S[1::2], device=dev)] = float("nan")
    xh[n + 2:] = float("nan")
    case = dia_case("f32-holey-nonfinite-x", H, xh, True)
    yh = H @ xh
    check(bool(torch.isfinite(yh).all()), "holey case: y must stay finite")
    cases.append(case)
    cases.append(dia_case("f32-rect-tall", band(n + 300, n, [-7, 0, 3],
                                                torch.float32),
                          randx(n), True))
    n2 = 1 << 19
    far = (1 << 17) + 3
    cases.append(dia_case("f32-offsets-past-2^17",
                          band(n2, n2, [-far, -129, 0, 129, far],
                               torch.float32), randx(n2), True))
    cases.append(dia_case("bf16", band(n, n, [-2, -1, 0, 1, 2],
                                       torch.bfloat16),
                          randx(n, torch.bfloat16), True))

    def block_clustered(rows, blocks_per_row, per_block):
        return block_clustered_arrays(rng, rows, blocks_per_row, per_block)

    def same_nonfinite(y, ref, rtol: float, what: str) -> float:
        """The NaN/inf pattern equal element for element, the finite
        values within ``rtol`` of the largest; the max |Δ| over them."""
        sync()
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            check(torch.equal(test(y), test(ref)),
                  f"{what}: {test.__name__} pattern differs")
        fin = torch.isfinite(ref)
        err = max_abs(y[fin], ref[fin])
        scale = float(ref[fin].float().abs().max()) if fin.any() else 0.0
        check(err <= rtol * max(scale, 1.0), f"{what}: max |Δ| {err} > "
              f"{rtol} * {scale}")
        return err

    def bsr_edge_case():
        """Canonical scipy CSR, 4096 x 8192: block-row 0 holds 40 present
        blocks (more than the SpMV kernel stages at once), block-row 1
        is empty, row 300 holds 6,000 entries, the other block-rows 2
        blocks of 2 entries per row.  And an x with inf at a column that
        row 0 stores (a*inf there, 0*inf = NaN in the rows of block-row
        0 that do not store it), NaN at a column of a present block of
        block-row 5 that none of its rows stores, and inf in chunk 0,
        under block-row 1's zero block."""
        nr, nc = 4096, 8192
        r = [np.repeat(np.arange(128), 40)]
        c = [np.tile(rng.choice(64, 40, replace=False) * 128, 128)
             + rng.integers(0, 128, 128 * 40)]
        r.append(np.full(6000, 300))
        c.append(rng.choice(nc, 6000, replace=False))
        rest = np.arange(256, nr)
        rest = rest[rest != 300]
        bc = rng.integers(0, 64, (nr // 128, 2))
        r.append(np.repeat(rest, 4))
        c.append((bc[rest // 128][:, [0, 0, 1, 1]] * 128
                  + rng.integers(0, 128, (rest.shape[0], 4))).reshape(-1))
        r, c = np.concatenate(r), np.concatenate(c)
        S = sp.csr_array((rng.standard_normal(r.shape[0]).astype(np.float32),
                          (r, c)), shape=(nr, nc))
        S.sum_duplicates()
        x = rng.standard_normal(nc).astype(np.float32)
        x[S.indices[S.indptr[0]]] = np.inf
        br5 = S[640:768]
        chunk = int(br5.indices[0]) // 128
        stored = set(br5.indices.tolist())
        x[next(cc for cc in range(chunk * 128, chunk * 128 + 128)
               if cc not in stored)] = np.nan
        x[5] = np.inf
        return S, x

    def bsr_check(name, st, dtype, ks, x_np=None):
        """Both BSR kernels on structure ``st`` against their plain
        versions; ``x_np`` (a column of X for SpMM) may hold inf/NaN."""
        x = randx(st.nbc * 128, dtype)
        if x_np is not None:
            x[: x_np.shape[0]] = torch.from_numpy(x_np).to(dev, dtype)
        x2d = x.reshape(-1, 128)
        y = bsr_ops.bsr_spmv(st, x2d)
        yp = bsr_ops.bsr_spmv_plain(st, x2d)
        out = [{"case": name, "kernel": "bsr_spmv", "rows": st.rows,
                "blocks": st.nblocks, "nnz": int(st.data.shape[0]),
                "max_blocks_per_block_row":
                    int((st.bptr[1:] - st.bptr[:-1]).max()),
                "nonfinite_y": int((~torch.isfinite(yp)).sum()),
                "max_abs_err": same_nonfinite(y, yp, 1e-5, name)}]
        for k in ks:
            X = randX(st.nbc * 128, k, dtype)
            if x_np is not None:
                X[: x_np.shape[0], k // 2] = torch.from_numpy(x_np).to(
                    dev, dtype)
            Y = bsr_ops.bsr_spmm(st, X)
            Yp = bsr_ops.bsr_spmm_plain(st, X)
            out.append({"case": f"{name}-k{k}", "kernel": "bsr_spmm", "k": k,
                        "nonfinite_y": int((~torch.isfinite(Yp)).sum()),
                        "max_abs_err": same_nonfinite(Y, Yp, 1e-5,
                                                      f"{name}-k{k}")})
        return out

    bsr_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        d, i, p = block_clustered(1 << 16, 8, 2)
        B = sparse.csr_array((d, i, p), shape=(1 << 16, 1 << 16),
                             dtype=dtype)
        st = B._get_bsr()
        check(st is not None, f"BSR {dtype}: structure must build")
        bsr_cases += bsr_check(f"bsr-{dname}", st, dtype, (1, 5, 16, 512))
        S_edge, x_nf = bsr_edge_case()
        E = sparse.csr_array(S_edge, dtype=dtype, device=dev)
        st = E._get_bsr()
        check(st is not None, f"BSR edge {dtype}: structure must build")
        check(st.brow.tolist().count(1) == 1, "edge: block-row 1 is empty")
        edge = bsr_check(f"bsr-edge-nonfinite-{dname}", st, dtype,
                         (5, 16, 40), x_nf)
        check(all(c["nonfinite_y"] > 0 for c in edge),
              "edge: the inf/NaN in x must reach y")
        bsr_cases += edge
        bsr_cases += bsr_check(f"bsr-edge-int64-{dname}", bsr_ops.BsrStructure(
            st.data, st.indices.to(torch.int64), st.indptr, st.brow, st.bcol,
            st.bptr, st.nbr, st.nbc, st.rows, st.cols), dtype, (16,), x_nf)
        del B, E, st

    def dia_spmm_case(name, A, X):
        packed = A._get_dia_pack()
        check(packed is not None, f"{name}: the DIA kernel must take it")
        Y = dia_kernel.dia_spmm(packed, X)
        Yp = dia_kernel.dia_spmm_plain(packed.rdata, packed.rmask, X,
                                       packed.offsets, packed.shape)
        err = close(Y, Yp, 1e-6, name)
        check(torch.equal(Y, Yp), f"{name}: not bitwise equal")
        return {"case": name, "rows": packed.shape[0],
                "cols": packed.shape[1], "k": X.shape[1],
                "offsets": list(packed.offsets), "dtype": str(X.dtype),
                "masked": packed.rmask is not None, "max_abs_err": err,
                "bitwise": True}

    spmm_cases = []
    E = band(n, n, [-2, -1, 0, 1, 2], torch.float32)
    for k in (1, 7, 16):
        spmm_cases.append(dia_spmm_case(f"f32-exact-k{k}", E, randX(n, k)))
    spmm_cases.append(dia_spmm_case(
        "f32-exact-k1024", band(1 << 16, 1 << 16, [-2, -1, 0, 1, 2],
                                torch.float32), randX(1 << 16, 1024)))
    # The holey band of the SpMV case: X rows that only holes reach, and
    # rows past the band's reach, hold inf/NaN.
    Xh = randX(m, 7)
    Xh[torch.as_tensor(S[::2], device=dev)] = float("inf")
    Xh[torch.as_tensor(S[1::2], device=dev)] = float("nan")
    Xh[n + 2:] = float("nan")
    spmm_cases.append(dia_spmm_case("f32-holey-nonfinite-X-k7", H, Xh))
    Yh = H @ Xh
    check(H.spmm_path == "dia-kernel", f"holey SpMM took {H.spmm_path}")
    check(bool(torch.isfinite(Yh).all()), "holey SpMM: Y must stay finite")
    spmm_cases.append(dia_spmm_case(
        "f32-rect-tall-k7", band(n + 300, n, [-7, 0, 3], torch.float32),
        randX(n, 7)))
    spmm_cases.append(dia_spmm_case(
        "bf16-k16", band(n, n, [-2, -1, 0, 1, 2], torch.bfloat16),
        randX(n, 16, torch.bfloat16)))

    # Where the DIA kernels switch variants (16-byte or scalar; an
    # unrolled or a chunked diagonal loop), on packs with holes and dead
    # columns (every slot a hole), where x and X hold inf and NaN.
    def holey_pack(rows, cols, nd, dtype):
        offsets = tuple(2 * d - nd for d in range(nd))
        data = rng.standard_normal((nd, cols)).astype(np.float32)
        keep = rng.random((nd, cols)) > 0.2
        dead = np.arange(5, cols, 997)
        keep[:, dead] = False
        data[~keep] = 0.0
        packed = dia_kernel.pack_band(
            torch.from_numpy(data).to(dev, dtype), offsets, (rows, cols),
            torch.from_numpy(keep).to(dev))
        check(packed is not None, "variant case: the kernel must take it")
        return packed, torch.as_tensor(dead, device=dev)

    def offset_view(shape, dtype, offset):
        numel = int(np.prod(shape))
        buf = torch.from_numpy(rng.standard_normal(numel + offset).astype(
            np.float32)).to(dev, dtype)
        return buf[offset:].view(shape)

    def variant_case(name, rows, nd, dtype, k=None, offset=0):
        packed, dead = holey_pack(rows, rows, nd, dtype)
        x = offset_view((rows,) if k is None else (rows, k), dtype, offset)
        x[dead[::2]] = float("inf")
        x[dead[1::2]] = float("nan")
        if k is None:
            y = dia_kernel.dia_spmv(packed, x)
            yp = dia_kernel.dia_spmv_plain(packed.rdata, packed.rmask, x,
                                           packed.offsets, packed.shape)
            vec = dia_kernel.spmv_vector_ok(packed)
        else:
            y = dia_kernel.dia_spmm(packed, x)
            yp = dia_kernel.dia_spmm_plain(packed.rdata, packed.rmask, x,
                                           packed.offsets, packed.shape)
            vec = dia_kernel.spmm_vector_ok(packed, x)
        sync()
        check(bool(torch.isfinite(y).all()), f"{name}: y must stay finite")
        check(torch.equal(y, yp), f"{name}: not bitwise equal")
        return {"case": name, "kernel": "dia_spmv" if k is None
                else "dia_spmm", "rows": rows, "nd": nd, "k": k,
                "dtype": str(dtype), "x_offset_elems": offset,
                "variant": "16-byte" if vec else "scalar",
                "diag_loop": ("unrolled" if vec and nd <=
                              dia_kernel.UNROLLED_DIAGS else "chunked"),
                "bitwise": True}

    odd = n + 3
    variant_cases = [
        variant_case("spmv-f32-odd-rows", odd, 5, torch.float32),
        variant_case("spmv-f32-unaligned-x", n, 5, torch.float32, offset=1),
        variant_case("spmv-f32-nd9", n, 9, torch.float32),
        variant_case("spmv-f32-nd33", n, 33, torch.float32),
        variant_case("spmv-bf16-odd-rows", odd, 5, torch.bfloat16),
        variant_case("spmv-bf16-nd9-unaligned-x", n, 9, torch.bfloat16,
                     offset=1),
        variant_case("spmm-f32-k5", n, 5, torch.float32, k=5),
        variant_case("spmm-f32-k16-unaligned-X", n, 5, torch.float32, k=16,
                     offset=1),
        variant_case("spmm-f32-k16-nd9", n, 9, torch.float32, k=16),
        variant_case("spmm-f32-k17-nd33", 1 << 16, 33, torch.float32, k=17),
        variant_case("spmm-bf16-k12-odd-rows", odd, 5, torch.bfloat16,
                     k=12),
        variant_case("spmm-bf16-k16-nd9", n, 9, torch.bfloat16, k=16)]
    check([c["variant"] for c in variant_cases]
          == ["scalar", "16-byte", "16-byte", "16-byte", "scalar", "16-byte",
              "scalar", "scalar", "16-byte", "scalar", "scalar", "16-byte"],
          f"variants taken: {[c['variant'] for c in variant_cases]}")

    # A strided x through csr_array.dot: X[:, 0] and X[:, :1].
    St = band(n, n, [-2, -1, 0, 1, 2], torch.float32)
    Xs = randX(n, 3)
    ys = St @ Xs[:, 0]
    check(St.spmv_path == "dia-kernel", f"strided x took {St.spmv_path}")
    ys1 = St @ Xs[:, :1]
    check(St.spmv_path == "dia-kernel" and tuple(ys1.shape) == (n, 1),
          f"X[:, :1] took {St.spmv_path}, shape {tuple(ys1.shape)}")
    ps = St._get_dia_pack()
    yps = dia_kernel.dia_spmv_plain(ps.rdata, ps.rmask, Xs[:, 0].contiguous(),
                                    ps.offsets, ps.shape)
    sync()
    check(torch.equal(ys, yps) and torch.equal(ys1[:, 0], yps),
          "strided x: not bitwise equal to the plain version")
    variant_cases.append({"case": "csr-dot-strided-x", "kernel": "dia_spmv",
                          "rows": n, "calls": ["A @ X[:, 0]", "A @ X[:, :1]"],
                          "path": St.spmv_path, "bitwise": True})
    del St, Xs, ys, ys1, yps, ps

    def spgemm_offs_c(offs_a, offs_b):
        return tuple(sorted({oa + ob for oa in offs_a for ob in offs_b}))

    def spgemm_case(name, m_, k_, n_, offs_a, offs_b, dtype, aliased=False,
                    twice=False):
        """The SpGEMM kernel against its plain version, bit for bit, with
        the variant it took.  ``aliased``: one tensor as A and B;
        ``twice``: two calls with no synchronisation between."""
        a = randX(len(offs_a), k_, dtype)
        b = a if aliased else randX(len(offs_b), n_, dtype)
        offs_c = spgemm_offs_c(offs_a, offs_b)
        pairs = dia_kernel.spgemm_pairs(offs_a, offs_b, offs_c, (m_, k_),
                                        (k_, n_))
        tiled = dia_kernel.spgemm_tiled_ok(
            offs_a, offs_b, offs_c, sum(map(len, pairs)), (m_, k_),
            (k_, n_), dtype)
        C = dia_kernel.dia_spgemm(a, b, offs_a, offs_b, offs_c, (m_, k_),
                                  (k_, n_))
        C2 = (dia_kernel.dia_spgemm(a, b, offs_a, offs_b, offs_c, (m_, k_),
                                    (k_, n_)) if twice else C)
        Cp = dia_kernel.dia_spgemm_plain(a, b, offs_a, offs_b, offs_c,
                                         (m_, k_), (k_, n_))
        err = close(C, Cp, 1e-6, name)
        check(torch.equal(C, Cp) and torch.equal(C2, Cp),
              f"{name}: not bitwise equal")
        empty = [ci for ci, ps in enumerate(pairs) if not ps]
        check(not empty or not bool(C[empty].any()),
              f"{name}: an output diagonal with no pair is not 0")
        return {"case": name, "shape_a": [m_, k_], "shape_b": [k_, n_],
                "offs_a": list(offs_a) if len(offs_a) <= 9 else len(offs_a),
                "offs_b": list(offs_b) if len(offs_b) <= 9 else len(offs_b),
                "dtype": str(dtype), "variant": "tiled" if tiled
                else "general", "empty_diags": len(empty),
                "max_abs_err": err, "bitwise": True}

    pm2 = (-2, -1, 0, 1, 2)
    spgemm_cases = [
        spgemm_case("f32-pm012", n, n, n, pm2, pm2, torch.float32),
        spgemm_case("f32-offsets-past-2^17", n2, n2, n2, (-far, 0, 129),
                    (-129, 0, far), torch.float32),
        spgemm_case("f32-rect", n, n - 1000, n + 500, (-3, 0, 2),
                    (-1, 0, 4), torch.float32),
        spgemm_case("bf16-pm012", n, n, n, pm2, pm2, torch.bfloat16)]
    # Where the kernel switches between its tiled and general variants,
    # and its tiles' edges (1,024 columns a tile).
    nd9 = tuple(2 * d - 9 for d in range(9))
    nd33 = tuple(2 * d - 33 for d in range(33))
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        # offs_a = (-1, 0), offs_b = (0, span): 4 output diagonals, 4
        # pairs.
        span = dia_kernel.spgemm_max_span(2, 2, 4, 4, dtype)
        spgemm_cases += [
            spgemm_case(f"{dn}-n-below-tile", 700, 700, 700, pm2, pm2, dtype),
            spgemm_case(f"{dn}-n-not-tile-multiple", n, n + 1, n - 3,
                        (-3, 0, 2), (-1, 0, 4), dtype),
            spgemm_case(f"{dn}-rect-empty-diag", 1500, 1200, 1300,
                        (-1499, 0, 3), (-1199, 0, 2), dtype),
            spgemm_case(f"{dn}-reach-at-limit", span + 600, span + 600,
                        span + 600, (-1, 0), (0, span), dtype),
            spgemm_case(f"{dn}-reach-past-limit", span + 601, span + 601,
                        span + 601, (-1, 0), (0, span + 1), dtype),
            spgemm_case(f"{dn}-nd9", 1 << 18, 1 << 18, 1 << 18, nd9, nd9,
                        dtype),
            spgemm_case(f"{dn}-nd33", 1 << 16, 1 << 16, 1 << 16, nd33, nd33,
                        dtype),
            spgemm_case(f"{dn}-aliased", n, n, n, pm2, pm2, dtype,
                        aliased=True),
            spgemm_case(f"{dn}-twice-no-sync", n, n, n, pm2, pm2, dtype,
                        twice=True)]
    check([c["variant"] for c in spgemm_cases]
          == ["tiled", "general", "tiled", "tiled"]
          + ["tiled"] * 4 + ["general", "tiled", "general", "tiled", "tiled"]
          + ["tiled"] * 4 + ["general", "tiled", "tiled", "tiled", "tiled"],
          f"SpGEMM variants taken: {[c['variant'] for c in spgemm_cases]}")
    check(all(c["empty_diags"] > 0 for c in spgemm_cases
              if "empty-diag" in c["case"]),
          "rect-empty-diag must have an output diagonal with no pair")
    log({"phase": "kernels_vs_plain", "dia": cases, "bsr": bsr_cases,
         "dia_spmm": spmm_cases, "dia_variants": variant_cases,
         "dia_spgemm": spgemm_cases})
    del H, xh, yh, Xh, Yh, E
    torch.cuda.empty_cache()

    csr_phases.close("3")

    # ---- 4. main path: pde_4096 -------------------------------------------
    reset_counts()
    grid = 4096
    n = grid * grid
    main3 = np.full(n, 4.0, np.float32)
    p1 = np.full(n - 1, -1.0, np.float32)
    p1[np.arange(1, grid) * grid - 1] = 0.0
    pN = np.full(n - grid, -1.0, np.float32)
    offsets = [0, 1, -1, grid, -grid]
    t0 = time.perf_counter()
    A = sparse.diags([main3, p1, p1, pN, pN], offsets, shape=(n, n),
                     format="csr", dtype=torch.float32)
    x = randx(n)
    y = A @ x
    sync()
    build_path_s = time.perf_counter() - t0
    check(A.spmv_path == "dia-kernel", f"pde SpMV took {A.spmv_path}")
    A_sp = sp.diags([d.astype(np.float64) for d in (main3, p1, p1, pN, pN)],
                    offsets, shape=(n, n), format="csr")
    xn = x.double().cpu().numpy()
    y_ref = A_sp @ xn
    mag = abs(A_sp) @ np.abs(xn)
    spmv_err = float(np.max(np.abs(y.double().cpu().numpy() - y_ref)))
    check(bool(np.all(np.abs(y.double().cpu().numpy() - y_ref)
                      <= 2e-6 * mag + 1e-30)),
          f"pde SpMV vs scipy f64: max |Δ| {spmv_err}")
    del y_ref, mag, xn

    b = torch.full((n,), 1e-6, dtype=torch.float32, device=dev)
    v = torch.ones(n, dtype=torch.float32, device=dev)
    explicit_ms = time_ms(lambda: v - 0.25 * (A @ v) + b)

    before = dia_kernel.dia_spmv.launches
    rhs = torch.ones(n, dtype=torch.float32, device=dev)
    sync()
    t0 = time.perf_counter()
    xs, iters = linalg.cg(A, rhs, rtol=0.0, maxiter=500)
    sync()
    cg_s = time.perf_counter() - t0
    cg_launches = dia_kernel.dia_spmv.launches - before
    check(iters == 500, f"cg ran {iters} iterations, expected 500")
    check(cg_launches == iters + 1,
          f"cg launched the DIA kernel {cg_launches} times for {iters} "
          f"iterations")
    check(bool(torch.isfinite(xs).all()), "cg iterate must be finite")
    del xs, rhs

    sol = pde.solve(512, 512, tol=1e-5, dtype=torch.float32)
    check(sol["path"] == "dia-kernel", f"pde app took {sol['path']}")
    # f32 cannot hold this solution to a true residual of 1e-3: the
    # rounding of x alone leaves ``residual_floor`` (apps/pde.py).  The
    # residual is held to that floor and the iterate to the exact
    # solution.
    check(sol["rel_residual"] <= max(1e-3, 2.0 * sol["residual_floor"]),
          f"pde app true relative residual {sol['rel_residual']} (f32 "
          f"floor {sol['residual_floor']})")
    check(sol["rel_error_to_exact"] <= 1e-3,
          f"pde app relative error to the exact solution "
          f"{sol['rel_error_to_exact']}")
    dia_launches = dia_kernel.dia_spmv.launches
    check(dia_launches > 0, "the main path launched no DIA kernel")
    log({"phase": "main_path_pde", "grid": f"{grid}x{grid}", "rows": n,
         "nnz": A.nnz, "path": A.spmv_path, "build_and_first_spmv_s":
         build_path_s, "spmv_max_abs_err_vs_scipy_f64": spmv_err,
         "explicit_step_ms_per_iter": explicit_ms,
         "cg_iters": iters, "cg_ms_per_iter": cg_s * 1e3 / iters,
         "cg_dia_launches": cg_launches,
         "pde_app": {k: sol[k] for k in ("grid", "n", "iters",
                                         "rel_residual", "residual_floor",
                                         "rel_error_to_exact", "solve_s",
                                         "path")},
         "dia_launches": dia_launches})
    del sol

    csr_phases.close("4")

    # ---- 6a. DIA timings at the pde shape -----------------------------------
    packed = A._get_dia_pack()
    nd = len(packed.offsets)
    yk = dia_kernel.dia_spmv(packed, x)
    yp = dia_kernel.dia_spmv_plain(packed.rdata, packed.rmask, x,
                                   packed.offsets, packed.shape)
    dia_err = close(yk, yp, 1e-6, "pde dia kernel vs plain")
    A_lib = torch.sparse_csr_tensor(A.indptr, A.indices.to(torch.int64),
                                    A.data, size=A.shape,
                                    check_invariants=False)
    y_lib = A_lib @ x
    close(y_lib, yp, 1e-5, "library csr SpMV vs plain")
    dia_bytes = nd * n * (4 + 1) + 4 * n + 4 * n
    dia_row = {
        "name": "dia_spmv", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "legate_sparse_tpu/ops/pallas_dia.py:312",
        "launches": dia_launches, "max_abs_err": dia_err,
        "ms": time_ms(lambda: dia_kernel.dia_spmv(packed, x)),
        "plain_ms": time_ms(lambda: dia_kernel.dia_spmv_plain(
            packed.rdata, packed.rmask, x, packed.offsets, packed.shape)),
        **bound(dia_bytes, 2 * nd * n),
        "library_ms": time_ms(lambda: A_lib @ x),
        "shape": {"rows": n, "diags": nd, "masked": True, "dtype": "float32",
                  "bytes": dia_bytes,
                  "variant": ("16-byte" if dia_kernel.spmv_vector_ok(packed)
                              else "scalar")},
    }
    log({"phase": "timing_dia", **dia_row})
    del yk, yp, y_lib, b, v

    csr_phases.close("6a")

    # ---- 5. SpMM on the pde operator ---------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    kX = 16
    X = torch.randn((n, kX), generator=gen, device=dev)
    reset_counts()
    Y = A @ X
    sync()
    spmm_counts = read_counts()
    check(A.spmm_path == "dia-kernel", f"pde SpMM took {A.spmm_path}")
    check(spmm_counts["dia_spmm"] > 0, "pde SpMM launched no DIA SpMM kernel")
    X3 = X[:, :3].double().cpu().numpy()
    diff = np.abs(Y[:, :3].double().cpu().numpy() - A_sp @ X3)
    spmm_err = float(diff.max())
    check(bool(np.all(diff <= 2e-6 * (abs(A_sp) @ np.abs(X3)) + 1e-30)),
          f"pde SpMM vs scipy f64: max |Δ| {spmm_err}")
    del A_sp, X3, diff
    log({"phase": "main_path_spmm_pde", "rows": n, "k": kX,
         "path": A.spmm_path, "spmm_max_abs_err_vs_scipy_f64": spmm_err,
         "launches": spmm_counts})
    Yk = dia_kernel.dia_spmm(packed, X)
    Yp = dia_kernel.dia_spmm_plain(packed.rdata, packed.rmask, X,
                                   packed.offsets, packed.shape)
    spmm_kernel_err = close(Yk, Yp, 1e-6, "pde dia SpMM kernel vs plain")
    check(torch.equal(Yk, Yp), "pde dia SpMM kernel: not bitwise equal")
    close(A_lib @ X, Yp, 1e-5, "library csr SpMM vs plain")
    del Yk, Yp
    nb_, nops_ = nd * n * (4 + 1) + 2 * 4 * n * kX, 2 * nd * n * kX
    dia_spmm_row = {
        "name": "dia_spmm", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/dia_spmm.cu",
        "replaces": "legate_sparse_tpu/ops/pallas_dia.py:417",
        "launches": spmm_counts["dia_spmm"],
        "max_abs_err": spmm_kernel_err,
        "ms": time_ms(lambda: dia_kernel.dia_spmm(packed, X)),
        "plain_ms": time_ms(lambda: dia_kernel.dia_spmm_plain(
            packed.rdata, packed.rmask, X, packed.offsets, packed.shape)),
        **bound(nb_, nops_),
        "library_ms": time_ms(lambda: A_lib @ X),
        "shape": {"rows": n, "diags": nd, "k": kX, "masked": True,
                  "dtype": "float32", "bytes": nb_,
                  "variant": ("16-byte" if dia_kernel.spmm_vector_ok(packed, X)
                              else "scalar")},
    }
    log({"phase": "timing_dia_spmm", **dia_spmm_row})
    del A, A_lib, packed, x, y, X, Y
    torch.cuda.empty_cache()

    csr_phases.close("5")

    # ---- 6. irregular SpMV and SpMM through BSR -----------------------------
    rows = 1 << 20
    d, i, p = block_clustered(rows, 8, 2)
    R = sparse.csr_array((d, i, p), shape=(rows, rows))
    x = randx(rows)
    # The structure is built on the card from R's own tensors, after the
    # band test that runs first on every matrix (the BSR probe caches the
    # row ids it reads when it takes the matrix).
    check(R._get_dia() is None, "the irregular matrix must not be banded")
    sync()
    t0 = time.perf_counter()
    st = R._get_bsr()
    sync()
    pack_s = time.perf_counter() - t0
    check(st is not None, "irregular BSR structure must build")
    check(st.extra_bytes < 1 << 20, f"BSR structure adds {st.extra_bytes} B")
    reset_counts()
    t0 = time.perf_counter()
    y = R @ x
    sync()
    bsr_first_s = time.perf_counter() - t0
    bsr_launches = bsr_ops.bsr_spmv.launches
    check(R.spmv_path == "bsr", f"irregular SpMV took {R.spmv_path}")
    check(bsr_launches > 0, "the irregular path launched no BSR kernel")
    R_sp = sp.csr_array((d.astype(np.float64), i, p), shape=(rows, rows))
    xn = x.double().cpu().numpy()
    diff = np.abs(y.double().cpu().numpy() - R_sp @ xn)
    bsr_spmv_err = float(diff.max())
    check(bool(np.all(diff <= 1e-5 * (abs(R_sp) @ np.abs(xn)) + 1e-30)),
          f"irregular SpMV vs scipy f64: max |Δ| {bsr_spmv_err}")
    del xn, diff
    log({"phase": "main_path_irregular", "rows": rows, "nnz": R.nnz,
         "blocks": st.nblocks, "path": R.spmv_path, "pack_s": pack_s,
         "structure_extra_bytes": st.extra_bytes,
         "first_spmv_s": bsr_first_s,
         "spmv_max_abs_err_vs_scipy_f64": bsr_spmv_err,
         "bsr_launches": bsr_launches})

    # ---- BSR timings at the irregular shape ---------------------------------
    # The plain versions densify the present blocks on every call: a
    # transient 4.3 GB at this shape, which the 80 GB card holds.
    x2d = x.reshape(-1, 128)
    yk = bsr_ops.bsr_spmv(st, x2d)
    yp = bsr_ops.bsr_spmv_plain(st, x2d)
    bsr_err = close(yk, yp, 1e-5, "irregular bsr kernel vs plain")
    R_lib = torch.sparse_csr_tensor(R.indptr, R.indices.to(torch.int64),
                                    R.data, size=R.shape,
                                    check_invariants=False)
    row_ids = R._get_row_ids()
    # Bytes of the work, each input read once and each output written
    # once: the stored nonzeros (values and column indices), indptr, x
    # (X) and y (Y), bcol and bptr; the same count bounds the library's
    # CSR product.
    csr_bytes = (R.nnz * (R.data.element_size() + R.indices.element_size())
                 + R.indptr.numel() * 8 + st.nblocks * 4 + (st.nbr + 1) * 8)
    bsr_bytes = csr_bytes + 2 * 4 * rows
    # csr-rowids as ``csr_array.dot`` would run it here: the CSR kernel
    # over the cached row offsets and schedule; and its plain ops.
    csr_rowids_kernel_ms = time_ms(lambda: spmv_ops.csr_spmv_rowids(
        R.data, R.indices, None, x, rows, lengths=R._get_row_lengths(),
        serial=R._serial_rows(), offsets=R.indptr,
        schedule=R._get_csr_schedule()))
    csr_rowids_plain_ms = time_ms(lambda: spmv_ops.csr_spmv_rowids_plain(
        R.data, R.indices, row_ids, x, rows,
        lengths=R._get_row_lengths(), serial=R._serial_rows()))
    bsr_row = {
        "name": "bsr_spmv", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/bsr_spmv.cu",
        "replaces": "legate_sparse_tpu/ops/bsr.py:143",
        "launches": bsr_launches, "max_abs_err": bsr_err,
        "ms": time_ms(lambda: bsr_ops.bsr_spmv(st, x2d)),
        "plain_ms": time_ms(lambda: bsr_ops.bsr_spmv_plain(st, x2d), reps=5),
        **bound(bsr_bytes, 2 * R.nnz),
        "library_ms": time_ms(lambda: R_lib @ x),
        "shape": {"rows": rows, "blocks": st.nblocks, "nnz": R.nnz,
                  "dtype": "float32", "bytes": bsr_bytes},
    }
    log({"phase": "timing_bsr", **bsr_row,
         "csr_rowids_kernel_ms": csr_rowids_kernel_ms,
         "csr_rowids_plain_ms": csr_rowids_plain_ms,
         "csr_rowids_kernel_vs_bsr": csr_rowids_kernel_ms / bsr_row["ms"]})
    del x2d, y, yk, yp

    X = torch.randn((rows, kX), generator=gen, device=dev)
    reset_counts()
    Y = R @ X
    sync()
    spmm_counts = read_counts()
    check(R.spmm_path == "bsr", f"irregular SpMM took {R.spmm_path}")
    check(spmm_counts["bsr_spmm"] > 0, "irregular SpMM launched no BSR SpMM "
          "kernel")
    X3 = X[:, :3].double().cpu().numpy()
    diff = np.abs(Y[:, :3].double().cpu().numpy() - R_sp @ X3)
    bsr_spmm_err = float(diff.max())
    check(bool(np.all(diff <= 1e-5 * (abs(R_sp) @ np.abs(X3)) + 1e-30)),
          f"irregular SpMM vs scipy f64: max |Δ| {bsr_spmm_err}")
    del R_sp, X3, diff
    log({"phase": "main_path_spmm_irregular", "rows": rows, "k": kX,
         "path": R.spmm_path,
         "spmm_max_abs_err_vs_scipy_f64": bsr_spmm_err,
         "launches": spmm_counts})
    Yk = bsr_ops.bsr_spmm(st, X)
    Yp = bsr_ops.bsr_spmm_plain(st, X)
    bsr_spmm_kernel_err = close(Yk, Yp, 1e-5, "irregular bsr SpMM vs plain")
    close(R_lib @ X, Yp, 1e-5, "library csr SpMM vs plain")
    del Yk, Yp
    nb_ = csr_bytes + 2 * 4 * rows * kX
    bsr_spmm_row = {
        "name": "bsr_spmm", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "legate_sparse_tpu/ops/bsr.py:198",
        "launches": spmm_counts["bsr_spmm"],
        "max_abs_err": bsr_spmm_kernel_err,
        "ms": time_ms(lambda: bsr_ops.bsr_spmm(st, X)),
        "plain_ms": time_ms(lambda: bsr_ops.bsr_spmm_plain(st, X), reps=5),
        **bound(nb_, 2 * R.nnz * kX),
        "library_ms": time_ms(lambda: R_lib @ X),
        "shape": {"rows": rows, "blocks": st.nblocks, "k": kX,
                  "nnz": R.nnz, "dtype": "float32", "bytes": nb_},
    }
    # csr-rowids SpMM as ``csr_array.dot`` would run it here: the CSR
    # kernel a column at a time.
    log({"phase": "timing_bsr_spmm", **bsr_spmm_row,
         "csr_rowids_kernel_ms": time_ms(lambda: spmv_ops.csr_spmm_rowids(
             R.data, R.indices, None, X, rows,
             lengths=R._get_row_lengths(), serial=R._serial_rows(),
             offsets=R.indptr, schedule=R._get_csr_schedule()))})
    del R, R_lib, st, x, X, Y, row_ids
    torch.cuda.empty_cache()

    csr_phases.close("6")

    # ---- 7. SpGEMM: banded (kernel) and general (ESC) -----------------------
    # examples/common.py::banded_matrix(2^24, 5): ones on 5 diagonals.
    N = 1 << 24
    half = 2
    cols = (np.tile(np.arange(-half, half + 1), N)
            + np.repeat(np.arange(N), 2 * half + 1))
    keep = (cols >= 0) & (cols < N)
    cols = cols[keep]
    counts = keep.reshape(N, 2 * half + 1).sum(axis=1)
    indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    ones = np.ones(cols.shape[0], dtype=np.float32)
    Ab = sparse.csr_array((ones, cols, indptr), shape=(N, N))
    Ab._get_dia()
    sync()
    reset_counts()
    t0 = time.perf_counter()
    C = Ab @ Ab
    sync()
    spgemm_s = time.perf_counter() - t0
    spgemm_counts = read_counts()
    check(Ab.spgemm_path == "dia-kernel",
          f"banded SpGEMM took {Ab.spgemm_path}")
    check(spgemm_counts["dia_spgemm"] > 0,
          "banded SpGEMM launched no DIA SpGEMM kernel")
    # A seeded sample of rows (the first and last among them) against
    # scipy's f64 product: small integers, so equal exactly.
    Ab_sp = sp.csr_array((ones.astype(np.float64), cols, indptr),
                         shape=(N, N))
    del cols, keep, counts, ones
    sel = np.unique(np.concatenate([[0, 1, N - 2, N - 1],
                                    rng.choice(N, 4092, replace=False)]))
    sel_t = torch.from_numpy(sel).to(dev)
    starts = C.indptr[sel_t]
    cnt = C.indptr[sel_t + 1] - starts
    total = int(cnt.sum())
    pos = (torch.repeat_interleave(starts - (torch.cumsum(cnt, 0) - cnt), cnt,
                                   output_size=total)
           + torch.arange(total, device=dev))
    sub = sp.csr_array((C.data[pos].double().cpu().numpy(),
                        C.indices[pos].cpu().numpy(),
                        np.concatenate([[0], np.cumsum(cnt.cpu().numpy())])),
                       shape=(sel.shape[0], N))
    ref = sp.csr_array(Ab_sp[sel] @ Ab_sp)
    ref.sort_indices()
    check(np.array_equal(sub.indptr, ref.indptr)
          and np.array_equal(sub.indices, ref.indices)
          and np.array_equal(sub.data, ref.data),
          "banded SpGEMM: sampled rows differ from scipy's f64 product")
    del Ab_sp, sub, ref, sel_t, starts, cnt, pos
    # The general route: the 1024x1024-grid Poisson operator (holes in
    # its band) squared through ESC, all of it against scipy.
    Pp = gmg_app.poisson2D(1024, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    Cp = Pp @ Pp
    sync()
    esc_s = time.perf_counter() - t0
    check(Pp.spgemm_path == "esc", f"Poisson SpGEMM took {Pp.spgemm_path}")
    Pp_sp = Pp.toscipy().astype(np.float64)
    ref = sp.csr_array(Pp_sp @ Pp_sp)
    ref.sort_indices()
    got = Cp.toscipy()
    check(np.array_equal(got.indptr, ref.indptr)
          and np.array_equal(got.indices, ref.indices)
          and np.array_equal(got.data.astype(np.float64), ref.data),
          "ESC SpGEMM: the Poisson square differs from scipy's f64 product")
    log({"phase": "main_path_spgemm", "rows": N, "nnz_a": Ab.nnz,
         "nnz_c": C.nnz, "path": Ab.spgemm_path, "spgemm_s": spgemm_s,
         "sampled_rows_vs_scipy_f64": int(sel.shape[0]),
         "launches": spgemm_counts,
         "esc": {"grid": "1024x1024", "rows": Pp.shape[0], "nnz_a": Pp.nnz,
                 "nnz_c": Cp.nnz, "path": Pp.spgemm_path, "seconds": esc_s,
                 "vs_scipy_f64": "equal"}})
    del Pp, Cp, Pp_sp, ref, got

    da = Ab._get_dia()
    offs_c = C._dia[1]
    nnz_c = C.nnz
    del C
    # Timed with B a distinct copy of A's band: with one tensor as both,
    # B's loads hit in L2 the bytes A just staged, and the bound would
    # count bytes that are never read from device memory.
    b_band = da[0].clone()
    spgemm_args = (da[1], da[1], offs_c, Ab.shape, Ab.shape)
    Ck = dia_kernel.dia_spgemm(da[0], b_band, *spgemm_args)
    Cpl = dia_kernel.dia_spgemm_plain(da[0], b_band, *spgemm_args)
    spgemm_kernel_err = close(Ck, Cpl, 1e-6, "banded SpGEMM kernel vs plain")
    check(torch.equal(Ck, Cpl), "banded SpGEMM kernel: not bitwise equal")
    del Ck, Cpl
    pairs = dia_kernel.spgemm_pairs(*spgemm_args)
    npairs = sum(map(len, pairs))
    nb_ = 4 * (2 * len(da[1]) * N + len(offs_c) * N)
    nops_ = 2 * sum(hi - lo for ps in pairs for (_, _, _, lo, hi) in ps)
    Ab_lib = torch.sparse_csr_tensor(Ab.indptr, Ab.indices.to(torch.int64),
                                     Ab.data, size=Ab.shape,
                                     check_invariants=False)
    dia_spgemm_row = {
        "name": "dia_spgemm", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/dia_spgemm.cu",
        "replaces": "legate_sparse_tpu/ops/pallas_dia.py:609",
        "launches": spgemm_counts["dia_spgemm"],
        "max_abs_err": spgemm_kernel_err,
        "ms": time_ms(lambda: dia_kernel.dia_spgemm(da[0], b_band,
                                                    *spgemm_args)),
        "plain_ms": time_ms(lambda: dia_kernel.dia_spgemm_plain(
            da[0], b_band, *spgemm_args)),
        **bound(nb_, nops_),
        "library_ms": time_ms(lambda: Ab_lib @ Ab_lib, reps=5),
        "shape": {"rows": N, "diags_a": len(da[1]), "diags_c": len(offs_c),
                  "pairs": npairs, "dtype": "float32", "bytes": nb_,
                  "b": "a distinct copy of A's band",
                  "variant": "tiled" if dia_kernel.spgemm_tiled_ok(
                      da[1], da[1], offs_c, npairs, Ab.shape, Ab.shape,
                      torch.float32) else "general"},
    }
    # The same INNER calls in a row under the profiler: the kernel's
    # device time beside its event time shows any host gap between the
    # calls, and the trace's copies and synchronisations show what a
    # call costs the stream (the loop ends on one event synchronize).
    prof = profile_calls(lambda: dia_kernel.dia_spgemm(da[0], b_band,
                                                       *spgemm_args),
                         "dia_spgemm")
    check(not prof["copies"]
          and sum(prof["synchronizations"].values()) < INNER,
          f"{INNER} dia_spgemm calls copied or synchronised per call: "
          f"{prof}")
    # ``A @ A`` as the main path runs it, one tensor as A and B: the
    # whole product (like for like with ``library_ms``, also a complete
    # CSR product) and its split, the kernel then ``band_to_csr``.
    Cd = dia_kernel.dia_spgemm(da[0], da[0], *spgemm_args)
    log({"phase": "timing_dia_spgemm", **dia_spgemm_row,
         "profiler": prof, "table_cache": str(
             dia_kernel.spgemm_table.cache_info()),
         "a_at_a_ms": time_ms(lambda: Ab @ Ab, reps=5),
         "a_at_a_split_ms": {
             "dia_spgemm_aliased": time_ms(lambda: dia_kernel.dia_spgemm(
                 da[0], da[0], *spgemm_args)),
             "band_to_csr": time_ms(lambda: dia_ops.band_to_csr(
                 Cd, offs_c, Ab.shape, nnz_c), reps=5)}})
    del Ab, Ab_lib, da, b_band, Cd
    torch.cuda.empty_cache()

    csr_phases.close("7")

    # ---- 8. GMG-preconditioned CG on the 4096x4096 Poisson grid -------------
    gmg_counts = {}

    @contextlib.contextmanager
    def counted():
        reset_counts()
        ell0 = ell_kernel.ell_spmv.launches
        yield
        gmg_counts.update(read_counts(),
                          ell_spmv=ell_kernel.ell_spmv.launches - ell0)

    grid = 4096
    sol = gmg_app.solve(grid, 8, gridop="linear", tol=1e-5,
                        dtype=torch.float32, device=dev, maxiter=200,
                        compare_plain=True, plain_maxiter=40000,
                        watch=counted)
    sync()
    x_gmg = sol.pop("x")
    mg = sol.pop("gmg")
    hierarchy = gmg_app.print_diagnostics(mg.operators)
    check(bool(torch.isfinite(x_gmg).all()), "GMG-CG iterate must be finite")
    check(sol["iters"] < 200, f"GMG-CG did not converge in {sol['iters']}")
    check(sol["iters"] < sol["plain_iters"],
          f"GMG-CG took {sol['iters']} iterations, plain CG "
          f"{sol['plain_iters']}")
    check(sol["rel_residual"] <= max(1e-5, 2.0 * sol["residual_floor"]),
          f"GMG-CG true relative residual {sol['rel_residual']} (f32 floor "
          f"{sol['residual_floor']})")
    check(all(p == {"R@A": "esc", "RA@P": "esc"}
              for p in sol["spgemm_paths"]), "GMG products must take ESC")
    # Launches of the GMG-CG solve alone: A @ x for r0 and A @ p per
    # iteration; per iteration one V-cycle, which applies each level's
    # A twice and its R and P once, on every level above the coarsest.
    iters = sol["iters"]
    cycle = sol["spmv_paths"][:sol["levels"] - 1]
    want = {"dia_spmv": (iters + 1) * (cycle[0]["A"] == "dia-kernel")
            + iters * 2 * sum(p["A"] == "dia-kernel" for p in cycle),
            "bsr_spmv": iters * sum((p["R"] == "bsr") + (p["P"] == "bsr")
                                    for p in cycle),
            "ell_spmv": iters * sum((p["R"] == "ell") + (p["P"] == "ell")
                                    for p in cycle)}
    check(want["dia_spmv"] > 0, "the GMG V-cycle has no DIA kernel path")
    check(want["ell_spmv"] > 0, "the GMG V-cycle has no ELL kernel path")
    for name, count in want.items():
        check(gmg_counts[name] == count,
              f"GMG-CG launched {name} {gmg_counts[name]} times, its "
              f"paths {sol['spmv_paths']} call for {count}")

    # Every level's Galerkin product R @ A @ P against scipy's f64
    # product of the same R, A and P, taken from the card, on a seeded
    # sample of its rows.  Each entry is held to 1e-5 of the sum of its
    # terms' magnitudes, (|R| |A| |P|): f32 rounding stays far below,
    # a lost or doubled ESC chunk far above.
    A_h = mg.A.toscipy().astype(np.float64)
    A_sp = A_h
    galerkin = []
    for level, (R_l, A_c, P_l) in enumerate(mg.operators):
        R_h = R_l.toscipy().astype(np.float64)
        P_h = P_l.toscipy().astype(np.float64)
        Ac_h = A_c.toscipy().astype(np.float64)
        sel = np.sort(rng.choice(A_c.shape[0], min(2048, A_c.shape[0]),
                                 replace=False))
        ref = sp.csr_array(R_h[sel] @ A_h) @ P_h
        mag = sp.csr_array(abs(R_h[sel]) @ abs(A_h)) @ abs(P_h)
        diff = abs(sp.csr_array(Ac_h[sel]) - ref)
        err = float(diff.max()) if diff.nnz else 0.0
        bad = diff - 1e-5 * mag
        check(not bad.nnz or float(bad.max()) <= 0.0,
              f"GMG level {level}: R @ A @ P differs from scipy's f64 "
              f"product by {err} on sampled rows")
        galerkin.append({"level": level, "rows": int(A_c.shape[0]),
                         "sampled_rows": int(sel.shape[0]),
                         "max_abs_err": err,
                         "max_magnitude": float(mag.max())})
        A_h = Ac_h
    del A_h, R_h, P_h, Ac_h, ref, mag, diff, bad

    # Every R and P of the V-cycle that took the ELL route, on a seeded x
    # of its column count: the kernel bit for bit the products summed in
    # slot order from +0.0 (``ell_spmv_ordered``), and within 1e-5 of the
    # plain ops (``ell_spmv_plain``, whose row sums take another order).
    ell_held = []
    ell_rng = np.random.default_rng(8)
    for level, (R_l, _A_c, P_l) in enumerate(mg.operators):
        for role, M in (("R", R_l), ("P", P_l)):
            if M.spmv_path != "ell":
                continue
            ell = M._get_ell()
            v = torch.from_numpy(ell_rng.standard_normal(
                M.shape[1]).astype(np.float32)).to(dev)
            y = ell_kernel.ell_spmv(*ell, v)
            what = f"GMG level {level} {role} ELL kernel"
            check(torch.equal(y, ell_kernel.ell_spmv_ordered(*ell, v)),
                  f"{what}: not bit for bit its slot-order sum")
            err = close(y, spmv_ops.ell_spmv_plain(*ell, v), 1e-5,
                        f"{what} vs plain")
            ell_held.append({"level": level, "role": role,
                             "shape": list(M.shape), "W": ell[0].shape[1],
                             "max_abs_err": err})
    check(len(ell_held) == sum((p["R"] == "ell") + (p["P"] == "ell")
                               for p in cycle),
          "an ELL route of the V-cycle was not held against its plain ops")

    # x against the exact solution of the f64 system, by the discrete
    # sine transform on the host: A = T (x) I + I (x) T with T =
    # tridiag(-1, 2, -1), whose eigenvectors are the DST-I basis.
    b64 = np.random.default_rng(0).random(grid * grid)
    lam = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, grid + 1) / (grid + 1))
    x_ref = fft.dstn(fft.dstn(b64.reshape(grid, grid), type=1, norm="ortho")
                     / (lam[:, None] + lam[None, :]), type=1,
                     norm="ortho").reshape(-1)
    ref_res = float(np.linalg.norm(A_sp @ x_ref - b64) / np.linalg.norm(b64))
    x_err = float(np.linalg.norm(x_gmg.double().cpu().numpy() - x_ref)
                  / np.linalg.norm(x_ref))
    # The first V-cycle builds every operator's structure caches.  With
    # the BSR blocks densified by a host-side pack it took 8.72-14.43 s
    # (H100 80GB HBM3, 700 W).
    log({"phase": "main_path_gmg", **sol,
         "first_cycle_s_with_host_bsr_pack": [8.72, 14.43],
         "launches": gmg_counts,
         "launches_expected": want, "galerkin_vs_scipy_f64": galerkin,
         "ell_held": ell_held,
         "rel_error_to_exact": x_err, "exact_ref_rel_residual": ref_res,
         "hierarchy_report": hierarchy.splitlines()})
    # x is ~10^6 times b: the f64 rounding of x alone leaves ~5e-10.
    check(ref_res <= 1e-8, f"DST reference residual {ref_res}")
    check(x_err <= 1e-4, f"GMG-CG relative error to the exact solution "
          f"{x_err}")
    # Phase 14 holds the distributed GMG-CG to this solve.
    ref_dir = tempfile.mkdtemp(prefix="chip-smoke-")
    atexit.register(shutil.rmtree, ref_dir, ignore_errors=True)
    gmg_ref = {"x": os.path.join(ref_dir, "x_gmg.npy"),
               "iters": sol["iters"], "ms_per_iter": sol["ms_per_iter"]}
    np.save(gmg_ref["x"], x_gmg.cpu().numpy())
    del x_gmg, sol, mg, A_sp, x_ref, b64
    torch.cuda.empty_cache()

    csr_phases.close("8")

    # ---- 8a. ELL timings at the 8192^2 V-cycle's level 0 ---------------------
    # The restriction R (W 9) and prolongation P = R.T (W 4) that the
    # 8192^2 GMG cell's V-cycle gives to the ELL kernel, f32, int32
    # columns: the kernel bit for bit its slot-order sum and within 1e-5
    # of the plain ops and the library, then timed.  ``bound_ms`` counts
    # the bytes the product needs, each once: the stored entries' values
    # and columns, the row counts, x and y; ``pack_bytes`` the ELL pack's
    # (its padded slots too), which the kernel reads.
    R8, _ = gmg_app.linear_operator(8192 * 8192, dtype=torch.float32,
                                    device=dev)
    ell_rows = []
    v8 = randx(R8.shape[1])
    for role, M, v in (("R", R8, v8), ("P", R8.T, None)):
        if v is None:
            v = R8.dot(v8)
        M.dot(v)
        check(M.spmv_path == "ell", f"8192^2 {role} took {M.spmv_path}")
        ell = M._get_ell()
        rows_e, W = ell[0].shape
        ci = ell[1].element_size()
        y = ell_kernel.ell_spmv(*ell, v)
        what = f"8192^2 level-0 {role} ELL kernel"
        check(torch.equal(y, ell_kernel.ell_spmv_ordered(*ell, v)),
              f"{what}: not bit for bit its slot-order sum")
        err = close(y, spmv_ops.ell_spmv_plain(*ell, v), 1e-5,
                    f"{what} vs plain")
        M_lib = torch.sparse_csr_tensor(M.indptr.to(torch.int32),
                                        M.indices.to(torch.int32), M.data,
                                        size=M.shape, check_invariants=False)
        close(M_lib @ v, y, 1e-5, f"library csr SpMV vs {what}")
        work_bytes = (M.nnz * (4 + ci) + 4 * rows_e + 4 * M.shape[1]
                      + 4 * rows_e)
        pack_bytes = (rows_e * W * (4 + ci) + 4 * rows_e + 4 * M.shape[1]
                      + 4 * rows_e)
        ell_rows.append({
            "name": "ell_spmv", "route": "cuda",
            "source": "legate_sparse_tpu_torch/csrc/ell_spmv.cu",
            "replaces": None, "launches": 0, "max_abs_err": err,
            "ms": time_ms(lambda: ell_kernel.ell_spmv(*ell, v)),
            "plain_ms": time_ms(lambda: spmv_ops.ell_spmv_plain(*ell, v)),
            **bound(work_bytes, 2 * M.nnz),
            "library_ms": time_ms(lambda: M_lib @ v),
            "shape": {"operator": role, "rows": rows_e,
                      "cols": int(M.shape[1]), "W": W, "nnz": int(M.nnz),
                      "dtype": "float32", "index_dtype": str(ell[1].dtype),
                      "bytes": work_bytes,
                      "pack_bytes": pack_bytes}})
        log({"phase": "timing_ell", **ell_rows[-1]})
        del ell, y, M_lib
    del R8, M, v, v8
    torch.cuda.empty_cache()

    csr_phases.close("8a")

    # ---- 8b. the CSR kernel at the rmat-s25 graph -----------------------------
    # The ``rmat-s25.matvec`` cell's operator (``spbench/operators/
    # kronecker.py``: a Graph500 Kronecker graph at SCALE 25, f32 values,
    # int32 columns, int64 row offsets) through ``csr_array.dot``: the
    # probes decline, the route is csr-rowids and takes the CSR kernel,
    # and the matrix then holds no row ids.  The kernel bit for bit its
    # twin and within 1e-5 of the plain ops, then timed beside the plain
    # ops and the library; ``bound_ms`` prices the operator's least bytes
    # (``kronecker.spmv_bytes``: values, columns and offsets read once, x
    # read and y written once).
    from spbench.operators import kronecker

    with open(os.path.join("spbench", "configs", "rmat-s25.json")) as f:
        g25_config = json.load(f)
    t0 = time.perf_counter()
    gd, gi, gp = kronecker.assemble(g25_config, torch.float32, dev, 0)
    sync()
    g25_assemble_s = time.perf_counter() - t0
    n25 = int(gp.shape[0]) - 1
    G25 = sparse.csr_array((gd, gi, gp), shape=(n25, n25))
    del gd, gi, gp
    x25 = torch.rand(n25, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(25))
    launches0 = csr_kernel.csr_spmv.launches
    sync()
    t0 = time.perf_counter()
    y25 = G25 @ x25
    sync()
    g25_first_s = time.perf_counter() - t0
    check(G25.spmv_path == "csr-rowids",
          f"the rmat-s25 graph took {G25.spmv_path}")
    check(csr_kernel.csr_spmv.launches == launches0 + 1,
          "the rmat-s25 product did not launch the CSR kernel once")
    check(G25._row_ids is None, "the rmat-s25 graph holds row ids")
    g25_held = torch.cuda.memory_allocated()
    csr_held.append(hold_csr_kernel("rmat-s25 A @ x", G25, x25, y25))
    sched25 = G25._get_csr_schedule()
    lengths25, serial25 = G25._get_row_lengths(), G25._serial_rows()

    def g25_kernel():
        return spmv_ops.csr_spmv_rowids(
            G25.data, G25.indices, None, x25, n25, lengths=lengths25,
            serial=serial25, offsets=G25.indptr, schedule=sched25)

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g25_kernel()
    sync()
    g25_product_bytes = torch.cuda.max_memory_allocated() - base
    g25_profile = profile_calls(g25_kernel, "csr_spmv")
    G25_lib = torch.sparse_csr_tensor(G25.indptr, G25.indices.to(torch.int64),
                                      G25.data, size=G25.shape,
                                      check_invariants=False)
    close(G25_lib @ x25, y25, 1e-5, "library csr SpMV vs the rmat-s25 kernel")
    g25_bytes = kronecker.spmv_bytes(g25_config)
    csr_row = {
        "name": "csr_spmv", "route": "cuda",
        "source": "legate_sparse_tpu_torch/csrc/csr_spmv.cu",
        "replaces": None, "launches": 0, "max_abs_err": 0.0,
        "ms": time_ms(g25_kernel),
        "plain_ms": time_ms(lambda: spmv_ops.csr_spmv_rowids_plain(
            G25.data, G25.indices, None, x25, n25, lengths=lengths25,
            serial=serial25), reps=5),
        **bound(g25_bytes, 2 * G25.nnz),
        "library_ms": time_ms(lambda: G25_lib @ x25, reps=5),
        "shape": {"operator": "rmat-s25", "rows": n25, "nnz": int(G25.nnz),
                  "dtype": "float32", "index_dtype": str(G25.indices.dtype),
                  "offset_dtype": str(G25.indptr.dtype),
                  "hub_rows": csr_held[-1]["hub_rows"],
                  "chunks": csr_held[-1]["chunks"], "tiles": sched25.tiles,
                  "bytes": g25_bytes}}
    log({"phase": "timing_csr", **csr_row, "assemble_s": g25_assemble_s,
         "first_spmv_s": g25_first_s, "held_bytes": g25_held,
         "product_extra_bytes": g25_product_bytes,
         "device_ms_per_kernel": g25_profile["kernels"],
         "hold": csr_held[-1]})
    del G25, G25_lib, x25, y25, sched25, lengths25
    torch.cuda.empty_cache()

    csr_phases.close("8b")

    # ---- 9. the scipy facade on the main path -------------------------------
    # The pde_4096 operator of phase 4, a block-clustered 2^20 matrix as in
    # phase 6 and an R-MAT graph at scale 20, through the facade into the
    # DIA and BSR kernels.  Each op's card ms (CUDA events around one
    # call, host syncs inside the op included; median of 5 after one
    # warmup) beside scipy's host seconds for the same op (one call).
    facade_t0 = time.perf_counter()

    def card_ms(fn, setup=None) -> float:
        samples = []
        for rep in range(6):
            arg = setup() if setup is not None else None
            sync()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(arg) if setup is not None else fn()
            end.record()
            end.synchronize()
            del out
            if rep:
                samples.append(start.elapsed_time(end))
        return float(np.median(samples))

    facade_ops = {}

    def timed(name, card_fn, host_fn, card_setup=None, host_setup=None):
        """Times ``name`` both ways; returns scipy's result, which the
        checks reuse."""
        arg = host_setup() if host_setup is not None else None
        t0 = time.perf_counter()
        res = host_fn(arg) if host_setup is not None else host_fn()
        host_s = time.perf_counter() - t0
        facade_ops[name] = {"card_ms": card_ms(card_fn, card_setup),
                            "scipy_host_s": host_s}
        return res

    def same_parts(P, Q, what):
        check(P.shape == Q.shape and torch.equal(P.indptr, Q.indptr)
              and torch.equal(P.indices.long(), Q.indices.long())
              and torch.equal(P.data, Q.data), f"{what}: not bit for bit")

    def within(y, ref, mag, rtol, what) -> float:
        d = np.abs(y.double().cpu().numpy() - ref)
        check(bool(np.all(d <= rtol * mag + 1e-30)),
              f"{what} vs scipy f64: max |Δ| {float(d.max())}")
        return float(d.max())

    reset_counts()
    grid = 4096
    n = grid * grid
    A = sparse.diags([main3, p1, p1, pN, pN], offsets, shape=(n, n),
                     format="csr", dtype=torch.float32)
    x = randx(n)
    A_sp = A.toscipy()                       # f32 on the host
    xn = x.double().cpu().numpy()
    yA = A @ x
    L, U = sparse.tril(A), sparse.triu(A, 1)
    S = L + U
    same_parts(S, A, "tril(A) + triu(A, 1)")
    yS = S @ x
    check(S.spmv_path == "dia-kernel", f"(L+U) @ x took {S.spmv_path}")
    check(torch.equal(yS, yA), "(L+U) @ x differs from A @ x")
    L_sp = timed("tril", lambda: sparse.tril(A), lambda: sp.tril(A_sp))
    U_sp = timed("triu", lambda: sparse.triu(A, 1),
                 lambda: sp.triu(A_sp, 1))
    S_sp = timed("L+U", lambda: L + U, lambda: L_sp + U_sp)
    timed("(L+U)@x", lambda: S @ x, lambda: S_sp @ xn)
    del L, U, S, L_sp, U_sp, S_sp, yS
    D = A - A.T
    D.eliminate_zeros()
    check(D.nnz == 0, f"(A - A.T).eliminate_zeros() left {D.nnz} entries")
    Ne = A != A.T
    check(Ne.nnz == 0, f"(A != A.T) has {Ne.nnz} entries")
    del D, Ne
    D_sp = timed("A-A.T", lambda: A - A.T, lambda: A_sp - A_sp.T)
    timed("eliminate_zeros", lambda D: D.eliminate_zeros(),
          lambda D: D.eliminate_zeros(), card_setup=lambda: A - A.T,
          host_setup=lambda: D_sp)
    del D_sp
    timed("A!=A.T", lambda: A != A.T, lambda: A_sp != A_sp.T)
    same_parts(A.tocoo().tocsr(), A, "A.tocoo().tocsr()")
    same_parts(A.tocsc().tocsr(), A, "A.tocsc().tocsr()")
    Ad = A.todia()
    check(torch.equal(Ad @ x, yA), "A.todia() @ x differs from A @ x")
    check(Ad.spmv_path == "dia-kernel", f"A.todia() @ x took {Ad.spmv_path}")
    del Ad
    timed("tocoo().tocsr()", lambda: A.tocoo().tocsr(),
          lambda: A_sp.tocoo().tocsr())
    timed("tocsc().tocsr()", lambda: A.tocsc().tocsr(),
          lambda: A_sp.tocsc().tocsr())
    timed("todia", lambda: A.todia(), lambda: A_sp.todia())
    # setdiag: values on the main diagonal, then a new diagonal k=2 (the
    # band and its kernel pack change), then B @ x on the new band.
    B = A.copy()
    B @ x
    B.setdiag(5.0)
    B.setdiag(1.0, k=2)
    yB = B @ x
    check(B.spmv_path == "dia-kernel", f"B @ x after setdiag took "
          f"{B.spmv_path}")
    check(B._dia_offsets == (-grid, -1, 0, 1, 2, grid),
          f"B's band after setdiag: {B._dia_offsets}")
    # B = A + I + (ones on diagonal 2): its product from scipy's A @ x.
    shift = np.zeros(n)
    shift[:n - 2] = xn[2:]
    setdiag_err = within(yB, A_sp @ xn + xn + shift,
                         abs(A_sp) @ np.abs(xn) + np.abs(xn) + np.abs(shift),
                         2e-6, "B @ x after setdiag")
    del B, yB, shift

    def sp_setdiag(M, v, k):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            M.setdiag(v, k=k)

    timed("setdiag(5.0)", lambda B: B.setdiag(5.0),
          lambda B: sp_setdiag(B, 5.0, 0), card_setup=A.copy,
          host_setup=A_sp.copy)
    timed("setdiag(1.0, k=2)", lambda B: B.setdiag(1.0, k=2),
          lambda B: sp_setdiag(B, 1.0, 2), card_setup=A.copy,
          host_setup=A_sp.copy)
    M = A.multiply(A)
    yM = M @ x
    check(M.spmv_path == "dia-kernel", f"A.multiply(A) @ x took "
          f"{M.spmv_path}")
    M_sp = timed("multiply", lambda: A.multiply(A),
                 lambda: A_sp.multiply(A_sp))
    multiply_err = within(yM, M_sp @ xn, abs(M_sp) @ np.abs(xn), 2e-6,
                          "A.multiply(A) @ x")
    del M, yM, M_sp
    absA = abs(A_sp)
    for axis in (0, 1):
        s = A.sum(axis=axis).double().cpu().numpy()
        ref = np.asarray(A_sp.sum(axis=axis, dtype=np.float64)).ravel()
        mag = np.asarray(absA.sum(axis=axis, dtype=np.float64)).ravel()
        check(bool(np.all(np.abs(s - ref) <= 1e-6 * mag)),
              f"A.sum(axis={axis}) vs scipy f64")
    check(float(A.max()) == float(A_sp.max()), "A.max() vs scipy")
    check(A.count_nonzero() == A_sp.count_nonzero(),
          "A.count_nonzero() vs scipy")
    sub, sub_sp = A[1000:2000], A_sp[1000:2000]
    check(np.array_equal(sub.indptr.cpu().numpy(), sub_sp.indptr)
          and np.array_equal(sub.indices.cpu().numpy(), sub_sp.indices)
          and np.array_equal(sub.data.cpu().numpy(), sub_sp.data),
          "A[1000:2000] vs scipy")
    pts = [(int(i), int(i + d)) for i, d in zip(
        rng.integers(grid, n - grid, 8), (0, 1, -1, grid, -grid, 2, 7, 0))]
    for i, j in pts:
        check(A[i, j] == A_sp[i, j], f"A[{i}, {j}] vs scipy")
    del sub, sub_sp, absA
    timed("sum(axis=0)", lambda: A.sum(axis=0), lambda: A_sp.sum(axis=0))
    timed("sum(axis=1)", lambda: A.sum(axis=1), lambda: A_sp.sum(axis=1))
    timed("max()", lambda: A.max(), lambda: A_sp.max())
    timed("count_nonzero()", lambda: A.count_nonzero(),
          lambda: A_sp.count_nonzero())
    timed("A[1000:2000]", lambda: A[1000:2000], lambda: A_sp[1000:2000])
    timed("A[i, j]", lambda: A[pts[0]], lambda: A_sp[pts[0]])
    pde_nnz = A.nnz
    del A, A_sp, x, xn, yA
    torch.cuda.empty_cache()

    # The irregular 2^20 matrix of phase 6's kind through BSR.
    rows = 1 << 20
    d, i, p = block_clustered(rows, 8, 2)
    R = sparse.csr_array((d, i, p), shape=(rows, rows))
    R_sp = sp.csr_array((d, i, p), shape=(rows, rows))
    x = randx(rows)
    R2 = R + R
    check(torch.equal(R2.indptr, R.indptr)
          and torch.equal(R2.indices.long(), R.indices.long()),
          "R + R changed R's pattern")
    y1 = R @ x
    y2 = R2 @ x
    check(R2.spmv_path == "bsr", f"(R + R) @ x took {R2.spmv_path}")
    check(torch.equal(y2, 2 * y1), "(R + R) @ x differs from 2 * (R @ x)")
    same_parts(R.T.T, R, "R.T.T")
    xr = x.cpu().numpy()
    R2_sp = timed("R+R", lambda: R + R, lambda: R_sp + R_sp)
    timed("R.T.T", lambda: R.T.T, lambda: R_sp.T.T.tocsr())
    timed("(R+R)@x", lambda: R2 @ x, lambda: R2_sp @ xr)
    del R, R2, R_sp, R2_sp, y1, y2, x, xr, d, i, p
    torch.cuda.empty_cache()

    # An R-MAT graph (Graph500's quadrants), symmetrised: the graph
    # user's step before BFS or PageRank.
    t0 = time.perf_counter()
    G = sparse.rmat(20, nnz_per_row=8, rng=0)
    sync()
    rmat_s = time.perf_counter() - t0
    G0 = G.copy()
    G_sp = G.toscipy()
    check(G.sum_duplicates() is None, "sum_duplicates returns None")
    G_sp.sum_duplicates()
    Gs = G + G.T
    Gs_sp = sp.csr_array(timed("G+G.T", lambda: G + G.T,
                               lambda: G_sp + G_sp.T))
    Gs_sp.sort_indices()
    # The pattern exactly; the values to f64 rounding: an edge sampled
    # many times is summed by a segment reduction on the card, in
    # another order than scipy's running sum.
    check(np.array_equal(Gs.indptr.cpu().numpy(), Gs_sp.indptr)
          and np.array_equal(Gs.indices.cpu().numpy(), Gs_sp.indices),
          "G + G.T: pattern differs from scipy's")
    gs_rel = float(np.max(np.abs(Gs.data.cpu().numpy() - Gs_sp.data)
                          / np.abs(Gs_sp.data)))
    check(gs_rel <= 1e-12, f"G + G.T values vs scipy: max rel |Δ| {gs_rel}")
    xg = randx(Gs.shape[1], torch.float64)
    yg = Gs @ xg
    xgn = xg.cpu().numpy()
    rmat_err = within(yg, Gs_sp @ xgn, abs(Gs_sp) @ np.abs(xgn), 1e-12,
                      "(G + G.T) @ x")
    check(Gs.spmv_path == "csr-rowids", f"(G + G.T) @ x took {Gs.spmv_path}")
    csr_held.append(hold_csr_kernel("phase 9 (G + G.T) @ x", Gs, xg, yg))
    timed("rmat sum_duplicates", lambda g: g.sum_duplicates(),
          lambda g: g.sum_duplicates(), card_setup=G0.copy,
          host_setup=G0.toscipy)
    timed("(G+G.T)@x", lambda: Gs @ xg, lambda: Gs_sp @ xgn)
    facade_counts = read_counts()
    check(facade_counts["dia_spmv"] > 0 and facade_counts["bsr_spmv"] > 0,
          f"the facade phase launched {facade_counts}")
    log({"phase": "main_path_facade", "nvidia_smi": smi_line,
         "pde": {"rows": n, "nnz": pde_nnz, "paths": {
             "(L+U)@x": "dia-kernel", "A.todia()@x": "dia-kernel",
             "B@x after setdiag": "dia-kernel",
             "A.multiply(A)@x": "dia-kernel"},
             "setdiag_then_dot_max_abs_err_vs_scipy_f64": setdiag_err,
             "multiply_then_dot_max_abs_err_vs_scipy_f64": multiply_err,
             "bitwise": ["L+U == A", "(L+U)@x == A@x", "A.todia()@x == A@x",
                         "A.tocoo().tocsr() == A", "A.tocsc().tocsr() == A"],
             "emptied": ["(A - A.T).eliminate_zeros()", "A != A.T"]},
         "irregular": {"rows": rows, "path": "bsr",
                       "bitwise": ["(R+R)@x == 2*(R@x)", "R.T.T == R"]},
         "rmat": {"scale": 20, "edges_sampled": G0.nnz, "nnz": G.nnz,
                  "nnz_symmetrised": Gs.nnz, "build_s": rmat_s,
                  "path": Gs.spmv_path,
                  "symmetrised_max_rel_err_vs_scipy_f64": gs_rel,
                  "dot_max_abs_err_vs_scipy_f64": rmat_err},
         "ops": facade_ops, "launches": facade_counts,
         "seconds": time.perf_counter() - facade_t0})
    del G, G0, G_sp, Gs, Gs_sp, xg, yg
    torch.cuda.empty_cache()

    csr_phases.close("9")

    # ---- 10. the solvers on the main path -----------------------------------
    # Three operators at full width, each solved from b = A @ x_true (x_true
    # seeded): the backward-Euler step of the heat equation on the
    # 4096x4096 grid (5 on the diagonal, -1 on +-1 with pde_4096's row-end
    # holes and on +-4096: SPD, kappa <= 9), upwinded convection-diffusion
    # on the same grid (-1.5 on -1, -0.5 on +1: nonsymmetric, diagonally
    # dominant), and a 2^20-row block-clustered matrix of phase 6's kind
    # whose diagonal block is one of every block-row's 8 and whose diagonal
    # is twice its row's other magnitudes (strictly dominant, through BSR).
    # Each run is held to its true relative residual in f64 (at most twice
    # the rtol asked), its error to x_true (1e-3) and launch counts equal
    # to what its returned iteration count calls for; a run's card time by
    # CUDA events around the call, host syncs included, after a warm-up
    # call of two iterations (the first use of cuBLAS and of each
    # elementwise kernel costs tens of ms once).
    solver_t0 = time.perf_counter()
    grid, irr_rows, io_grid = 4096, 1 << 20, 1024
    n = grid * grid
    solver_runs, solver_timing = {}, {}
    phase10 = {name: 0 for name in counters}

    def run(fn):
        """``fn()`` with the counts set to 0 just before it: its launches,
        card ms (CUDA events) and host s; the launches also add up in
        ``phase10``."""
        sync()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        for k, v in counts.items():
            phase10[k] += v
        return out, counts, start.elapsed_time(end), secs

    # Every kernel at each shape this phase gives it, against its plain
    # version on the same inputs, outside the counted runs: the DIA
    # kernels bit for bit, the BSR SpMV to 1e-5 of the largest |y| (its
    # sums run in another order), as phases 3-6 hold them.
    kernel_vs_plain = {}

    def hold(name, kernel, got, want):
        bitwise = kernel != "bsr_spmv"
        err = close(got, want, 1e-6 if bitwise else 1e-5, name)
        same = bool(torch.equal(got, want))
        check(same or not bitwise, f"{name}: kernel and plain version not "
              f"bit for bit equal")
        kernel_vs_plain[name] = {"kernel": kernel, "max_abs_err": err,
                                 "bitwise": same}

    def hold_dia_spmv(name, A, x):
        pk = A._get_dia_pack()
        check(pk is not None, f"{name}: the DIA kernel must take it")
        hold(name, "dia_spmv", dia_kernel.dia_spmv(pk, x),
             dia_kernel.dia_spmv_plain(pk.rdata, pk.rmask, x, pk.offsets,
                                       pk.shape))

    def expect(name, counts, **want):
        full = {k: want.get(k, 0) for k in counters}
        check(counts == full, f"{name} launched {counts}, its iterations "
              f"call for {full}")

    def rel_norm(v, ref) -> float:
        return float(torch.linalg.vector_norm(v.double() - ref.double())
                     / torch.linalg.vector_norm(ref.double()))

    def rel_residual(A64, x, b) -> float:
        return rel_norm(A64 @ x.double(), b)

    def judge(name, A, A64, b, x_true, x, iters, counts, ms, secs, rtol,
              path, unit="iteration", **extra):
        res = rel_residual(A64, x, b)
        err = rel_norm(x, x_true)
        check(bool(torch.isfinite(x).all()), f"{name}: x not finite")
        check(res <= 2 * rtol, f"{name}: true relative residual {res} > "
              f"2 * {rtol}")
        check(err <= 1e-3, f"{name}: relative error to x_true {err}")
        check(A.spmv_path == path, f"{name} took {A.spmv_path}")
        per = extra.pop("per", iters)
        solver_runs[name] = {"iters": iters, "rel_residual_f64": res,
                             "rel_error_to_x_true": err, "path": A.spmv_path,
                             "launches": {k: v for k, v in counts.items()
                                          if v},
                             f"ms_per_{unit}": ms / max(per, 1),
                             "card_ms": ms, "host_s": secs, **extra}

    hole = np.ones(n - 1, np.float32)
    hole[np.arange(1, grid) * grid - 1] = 0.0
    far = np.full(n - grid, -1.0, np.float32)
    ones = np.ones(n, np.float32)
    five_offsets = [0, 1, -1, grid, -grid]
    step = sparse.diags([5.0 * ones, -hole, -hole, far, far], five_offsets,
                        shape=(n, n), format="csr", dtype=torch.float32)
    convdiff = sparse.diags([5.0 * ones, -0.5 * hole, -1.5 * hole, far, far],
                            five_offsets, shape=(n, n), format="csr",
                            dtype=torch.float32)
    x_true = randx(n)
    b_step, b_cd = step @ x_true, convdiff @ x_true
    step64, cd64 = step.astype(torch.float64), convdiff.astype(torch.float64)
    hold_dia_spmv("step @ x", step, x_true)
    hold_dia_spmv("convdiff @ x", convdiff, x_true)

    # 1. CG with the two preconditioners.
    sync()
    t0 = time.perf_counter()
    Mj = linalg.jacobi(step)
    sync()
    jacobi_build_s = time.perf_counter() - t0
    linalg.cg(step, b_step, M=Mj, maxiter=2)
    (x, it), counts, ms, secs = run(lambda: linalg.cg(step, b_step, M=Mj,
                                                      rtol=1e-5))
    expect("cg+jacobi", counts, dia_spmv=it + 1)
    judge("cg+jacobi", step, step64, b_step, x_true, x, it, counts, ms, secs,
          1e-5, "dia-kernel", build_s=jacobi_build_s)
    del Mj
    sync()
    t0 = time.perf_counter()
    Mb = linalg.block_jacobi(step, 32)
    sync()
    bj_build_s = time.perf_counter() - t0
    bj_apply_ms = time_ms(lambda: Mb.matvec(b_step), reps=5)
    linalg.cg(step, b_step, M=Mb, maxiter=2)
    (x, it), counts, ms, secs = run(lambda: linalg.cg(step, b_step, M=Mb,
                                                      rtol=1e-5))
    expect("cg+block_jacobi", counts, dia_spmv=it + 1)
    judge("cg+block_jacobi", step, step64, b_step, x_true, x, it, counts, ms,
          secs, 1e-5, "dia-kernel", build_s=bj_build_s,
          apply_ms=bj_apply_ms, blocks=n // 32)
    log({"phase": "solvers_timing", "what": "block_jacobi(step, 32)",
         "build_s": bj_build_s, "apply_ms": bj_apply_ms,
         "cg_ms_per_iteration": solver_runs["cg+block_jacobi"][
             "ms_per_iteration"], "nvidia_smi": smi_line})
    del Mb, x
    torch.cuda.empty_cache()

    # 2. Nonsymmetric solves.  GMRES's host fetches are counted through
    # the one helper that makes them: [beta, resid] once a cycle (two
    # values), the true residual's norm at a suspected convergence (one).
    restart = 20
    linalg.gmres(convdiff, b_cd, restart=2, maxiter=2)
    fetches = []
    real_fetch = linalg._host_fetch

    def counted_fetch(t):
        fetches.append(t.numel())
        return real_fetch(t)

    linalg._host_fetch = counted_fetch
    try:
        (x, it), counts, ms, secs = run(lambda: linalg.gmres(
            convdiff, b_cd, restart=restart, rtol=1e-5))
    finally:
        linalg._host_fetch = real_fetch
    cycles, confirms = fetches.count(2), fetches.count(1)
    check(it in (cycles * restart, (cycles - 1) * restart),
          f"gmres: {it} iterations from {cycles} cycles")
    expect("gmres", counts, dia_spmv=cycles * (restart + 1) + confirms)
    # One cycle alone: no synchronising CUDA call inside it (PyTorch's
    # sync debug mode warns on each), and the card's busy share in it.
    op_cd = linalg.make_linear_operator(convdiff)
    x0 = torch.zeros_like(b_cd)

    def cycle():
        return linalg._gmres_cycle(op_cd.matvec, lambda v: v, x0, b_cd,
                                   restart)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            linalg._gmres_cycle(op_cd.matvec, lambda v: v, x0, b_cd, restart)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message)[:120] for w in caught
                    if "called a synchronizing" in str(w.message)})
    check(not syncs, f"a GMRES cycle synchronised: {syncs}")

    def event_ms(fn) -> float:
        """Median card ms of ``fn()`` alone (CUDA events), of 3 calls."""
        times = []
        for _ in range(3):
            sync()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    # The busy share: the cycle's device time alone (the same kernels
    # captured in a CUDA graph and replayed, so no host work sits
    # between them) over its time run eagerly as gmres runs it.  The
    # graph only measures; the solver runs the eager cycle.
    eager_ms = event_ms(cycle)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cycle()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graph_out = cycle()
    graph_ms = event_ms(graph.replay)
    x_eager, stats_eager = cycle()
    close(graph_out[0], x_eager, 1e-5, "captured GMRES cycle's x vs eager")
    close(graph_out[1], stats_eager, 1e-5,
          "captured GMRES cycle's [beta, resid] vs eager")
    del graph, graph_out, x_eager, stats_eager
    busy_share = graph_ms / eager_ms
    cycle_prof = gmg_app.profile_device(cycle, dev, top=4)
    judge("gmres", convdiff, cd64, b_cd, x_true, x, it, counts, ms, secs,
          1e-5, "dia-kernel", unit="cycle", per=cycles, restart=restart,
          cycles=cycles, host_fetches=len(fetches), confirms=confirms,
          syncs_in_a_cycle=0, cycle_eager_ms=eager_ms,
          cycle_graph_replay_ms=graph_ms, cycle_device_busy_share=busy_share,
          cycle_profile=cycle_prof)
    log({"phase": "solvers_timing", "what": "gmres(convdiff, restart=20)",
         "ms_per_cycle": solver_runs["gmres"]["ms_per_cycle"],
         "cycle_eager_ms": eager_ms, "cycle_graph_replay_ms": graph_ms,
         "cycle_device_busy_share": busy_share,
         "cycle_busy_share_under_profiler": cycle_prof["device_busy_share"],
         "nvidia_smi": smi_line})
    del op_cd, x0
    linalg.bicgstab(convdiff, b_cd, maxiter=2)
    (x, it), counts, ms, secs = run(lambda: linalg.bicgstab(convdiff, b_cd,
                                                            rtol=1e-5))
    expect("bicgstab", counts, dia_spmv=2 * it + 1)
    judge("bicgstab", convdiff, cd64, b_cd, x_true, x, it, counts, ms, secs,
          1e-5, "dia-kernel")
    del cd64, x
    torch.cuda.empty_cache()

    def dominant_clustered(rows):
        """Canonical CSR arrays of block_clustered(rows, 8, 2)'s kind, with
        the diagonal block among every block-row's 8, the diagonal entry
        stored, and the diagonal twice the row's other magnitudes."""
        nbr = rows // 128
        others = np.stack([rng.choice(nbr - 1, 7, replace=False)
                           for _ in range(nbr)])
        others += others >= np.arange(nbr)[:, None]
        bcols = np.sort(np.concatenate([np.arange(nbr)[:, None], others],
                                       axis=1), axis=1)
        row_bcols = np.repeat(bcols, 128, axis=0)             # (rows, 8)
        r = np.arange(rows)
        first = rng.integers(0, 128, (rows, 8))
        on_diag = row_bcols == (r // 128)[:, None]
        first[on_diag] = r % 128
        second = (first + 1 + rng.integers(0, 64, (rows, 8))) % 128
        cols = np.sort((row_bcols[:, :, None] * 128
                        + np.stack([first, second], axis=2)).reshape(rows, -1),
                       axis=1)
        check(bool((np.diff(cols, axis=1) > 0).all()), "columns distinct")
        vals = rng.standard_normal(cols.shape).astype(np.float32)
        diag = cols == r[:, None]
        check(bool((diag.sum(axis=1) == 1).all()), "one diagonal entry a row")
        vals[diag] = 0.0
        vals[diag] = 2.0 * np.abs(vals).sum(axis=1)
        indptr = np.arange(rows + 1, dtype=np.int64) * cols.shape[1]
        return vals.reshape(-1), cols.reshape(-1).astype(np.int32), indptr

    d, i, p = dominant_clustered(irr_rows)
    R = sparse.csr_array((d, i, p), shape=(irr_rows, irr_rows))
    check(R._get_dia() is None, "the irregular matrix must not be banded")
    st = R._get_bsr()
    check(st is not None and st.nblocks == irr_rows // 128 * 8,
          "the irregular matrix must take BSR with 8 blocks a block-row")
    xr_true = randx(irr_rows)
    b_r = R @ xr_true
    x2d = xr_true.reshape(-1, 128)
    hold("irregular @ x", "bsr_spmv", bsr_ops.bsr_spmv(st, x2d),
         bsr_ops.bsr_spmv_plain(st, x2d))
    del x2d
    R64 = R.astype(torch.float64)
    linalg.bicgstab(R, b_r, maxiter=2)
    (x, it), counts, ms, secs = run(lambda: linalg.bicgstab(R, b_r,
                                                            rtol=1e-5))
    expect("bicgstab(irregular)", counts, bsr_spmv=2 * it + 1)
    judge("bicgstab(irregular)", R, R64, b_r, xr_true, x, it, counts, ms,
          secs, 1e-5, "bsr", blocks=st.nblocks, nnz=R.nnz)
    del R, R64, st, d, i, p, x, xr_true, b_r
    torch.cuda.empty_cache()

    # 3. Symmetric and least-squares solves.  One operator object serves
    # LSQR and LSMR, as a user's would: its transpose for rmatvec is built
    # once (in the warm-up) and must be banded too.
    linalg.minres(step, b_step, maxiter=2)
    (x, it), counts, ms, secs = run(lambda: linalg.minres(step, b_step,
                                                          rtol=1e-5))
    expect("minres", counts, dia_spmv=it + 1)
    judge("minres", step, step64, b_step, x_true, x, it, counts, ms, secs,
          1e-5, "dia-kernel")
    op = linalg.make_linear_operator(step)
    linalg.lsqr(op, b_step, iter_lim=2)
    linalg.lsmr(op, b_step, maxiter=2)
    for name, solve in (("lsqr", linalg.lsqr), ("lsmr", linalg.lsmr)):
        out, counts, ms, secs = run(lambda: solve(op, b_step, atol=0.0,
                                                  btol=1e-5))
        x, istop, it = out[:3]
        check(istop == 1, f"{name} stopped with istop {istop}")
        check(op.AT.spmv_path == "dia-kernel",
              f"{name}'s transposed product took {op.AT.spmv_path}")
        expect(name, counts, dia_spmv=2 * it + 2)
        judge(name, step, step64, b_step, x_true, x, it, counts, ms, secs,
              1e-5, "dia-kernel", istop=istop,
              transpose_path=op.AT.spmv_path)
    hold_dia_spmv("step^T @ x (rmatvec)", op.AT, b_step)
    # Damped: (A^T A + damp^2 I) x = A^T b holds, b - A x does not vanish.
    # A is symmetric, so A^T = A.
    damp = 0.1
    atb = step64 @ b_step.double()
    for name, solve in (("lsqr(damp=0.1)", linalg.lsqr),
                        ("lsmr(damp=0.1)", linalg.lsmr)):
        out, counts, ms, secs = run(lambda: solve(op, b_step, damp=damp,
                                                  atol=1e-5, btol=1e-5))
        x, istop, it = out[:3]
        expect(name, counts, dia_spmv=2 * it + 2)
        x64 = x.double()
        normal = rel_norm(step64 @ (step64 @ x64) + damp ** 2 * x64, atb)
        check(normal <= 1e-4, f"{name}: normal-equation residual {normal}")
        solver_runs[name] = {"iters": it, "istop": istop,
                             "normal_equation_rel_residual_f64": normal,
                             "launches": {k: v for k, v in counts.items()
                                          if v},
                             "ms_per_iteration": ms / max(it, 1),
                             "card_ms": ms, "host_s": secs}
    del op, atb, x, x64

    # 4. A gradient through a solve: d<w, A^-1 b>/db = A^-1 w, one more
    # solve; held to a second solve of A y = w.
    w = randx(n)
    rtol_d = float(np.sqrt(torch.finfo(torch.float32).eps) * 1e-2)
    x_fwd, it_fwd = linalg.cg(step, b_step, rtol=rtol_d)
    y_ref, it_bwd = linalg.cg(step, w, rtol=rtol_d)
    bg = b_step.clone().requires_grad_()

    def grad_run():
        xg = linalg.differentiable_solve(step, bg)
        torch.dot(w, xg).backward()
        return xg.detach()

    xg, counts, ms, secs = run(grad_run)
    grad_err = rel_norm(bg.grad, y_ref)
    check(grad_err <= 1e-4, f"b.grad vs A^-1 w: relative error {grad_err}")
    expect("differentiable_solve", counts, dia_spmv=it_fwd + it_bwd + 2)
    judge("differentiable_solve", step, step64, b_step, x_true, xg,
          it_fwd + it_bwd, counts, ms, secs, rtol_d, "dia-kernel",
          grad_rel_err_vs_second_solve=grad_err, forward_iters=it_fwd,
          backward_iters=it_bwd)
    del w, bg, xg, x_fwd, y_ref, step64
    torch.cuda.empty_cache()

    # 5. expm_multiply(-0.5 L, B), L the pde_4096 Laplacian [4, -1], B four
    # of its DST eigenmodes: e^{-0.5 lambda_pq} B column by column.
    L = sparse.diags([4.0 * ones, -hole, -hole, far, far], five_offsets,
                     shape=(n, n), format="csr", dtype=torch.float32)
    Lh = -0.5 * L
    k = torch.arange(1, grid + 1, dtype=torch.float64, device=dev)
    modes = ((1, 1), (2, 3), (5, 2), (40, 17))
    B64 = torch.stack([torch.outer(torch.sin(np.pi * pm * k / (grid + 1)),
                                   torch.sin(np.pi * qm * k / (grid + 1)))
                       .reshape(-1) for pm, qm in modes], dim=1)
    lam = torch.tensor([4 - 2 * np.cos(np.pi * pm / (grid + 1))
                        - 2 * np.cos(np.pi * qm / (grid + 1))
                        for pm, qm in modes], dtype=torch.float64,
                       device=dev)
    exact = B64 * torch.exp(-0.5 * lam)
    Bm = B64.float()
    del B64, k
    norm1 = (float(abs(Lh).sum(axis=0).max())
             + abs(float(Lh.trace()) / n))
    s_steps, m_terms = max(1, int(np.ceil(norm1))), 13
    E, counts, ms, secs = run(lambda: linalg.expm_multiply(Lh, Bm))
    expm_err = float((E.double() - exact).abs().max())
    check(expm_err <= 1e-4, f"expm_multiply vs e^(-lambda/2) B: {expm_err}")
    check(Lh.spmm_path == "dia-kernel", f"expm_multiply's SpMM took "
          f"{Lh.spmm_path}")
    expect("expm_multiply", counts, dia_spmm=s_steps * m_terms)
    pk = Lh._get_dia_pack()
    hold(f"-0.5 L @ B, k = {Bm.shape[1]} "
         f"({'16-byte' if dia_kernel.spmm_vector_ok(pk, Bm) else 'scalar'})",
         "dia_spmm", dia_kernel.dia_spmm(pk, Bm),
         dia_kernel.dia_spmm_plain(pk.rdata, pk.rmask, Bm, pk.offsets,
                                   pk.shape))
    del pk
    e1, counts1, ms1, secs1 = run(lambda: linalg.expm_multiply(Lh,
                                                               Bm[:, 0]))
    expm1_err = float((e1.double() - exact[:, 0]).abs().max())
    check(expm1_err <= 1e-4, f"expm_multiply of a vector: {expm1_err}")
    # A vector's term is an SpMV: A @ X takes an (n, 1) X as a vector.
    expect("expm_multiply(vector)", counts1, dia_spmv=s_steps * m_terms)
    hold_dia_spmv("-0.5 L @ b", Lh, Bm[:, 0].contiguous())
    solver_runs["expm_multiply"] = {
        "k": Bm.shape[1], "s": s_steps, "m": m_terms, "norm1": norm1,
        "max_abs_err_vs_exact": expm_err, "path": Lh.spmm_path,
        "launches": {k_: v for k_, v in counts.items() if v},
        "card_ms": ms, "host_s": secs,
        "vector": {"max_abs_err_vs_exact": expm1_err, "path": Lh.spmv_path,
                   "launches": {k_: v for k_, v in counts1.items() if v},
                   "card_ms": ms1, "host_s": secs1}}
    log({"phase": "solvers_timing", "what": "expm_multiply(-0.5 L, B)",
         "seconds": secs, "vector_seconds": secs1, "nvidia_smi": smi_line})
    del Lh, Bm, E, e1, exact, lam

    # 6. norm(pde_4096) against scipy's on the host (f64).
    L_sp = L.toscipy().astype(np.float64)
    norms = {}
    for ord_ in (None, 1, np.inf):
        got, want = linalg.norm(L, ord=ord_), sp.linalg.norm(L_sp, ord=ord_)
        check(abs(got - want) <= 1e-6 * want, f"norm(ord={ord_}): {got} vs "
              f"scipy {want}")
        norms[str(ord_)] = got
    for axis in (0, 1):
        got = linalg.norm(L, axis=axis).double().cpu().numpy()
        want = sp.linalg.norm(L_sp, axis=axis)
        check(bool(np.all(np.abs(got - want) <= 1e-6 * want)),
              f"norm(axis={axis}) vs scipy")
        norms[f"axis={axis}"] = [float(got.min()), float(got.max())]
    solver_runs["norm"] = norms
    del L, L_sp, step, convdiff, x_true, b_step, b_cd, hole, far, ones
    torch.cuda.empty_cache()

    # 7. IO: the 1024x1024-grid Poisson matrix through mmwrite and mmread
    # (both parser tiers) and save_npz/load_npz, each read back bit for
    # bit and its product through the DIA kernel.
    P = gmg_app.poisson2D(io_grid, dtype=torch.float32, device=dev)
    xp = randx(P.shape[0])
    yp = P @ xp
    io_runs = {"rows": P.shape[0], "nnz": P.nnz}
    hold_dia_spmv("poisson 1024^2 @ x (io)", P, xp)

    def read_back(name, R, secs):
        same_parts(R, P, name)
        y, counts, _, _ = run(lambda: R @ xp)
        check(R.spmv_path == "dia-kernel", f"{name} @ x took {R.spmv_path}")
        check(torch.equal(y, yp), f"{name} @ x differs from P @ x")
        io_runs[name] = {"seconds": secs, "launches": counts["dia_spmv"]}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poisson.mtx")
        t0 = time.perf_counter()
        sparse.mmwrite(path, P)
        io_runs["mmwrite_s"] = time.perf_counter() - t0
        io_runs["file_bytes"] = os.path.getsize(path)
        real_load = utils_native._load
        utils_native._load = lambda: None          # the numpy tier
        try:
            t0 = time.perf_counter()
            R = sparse.mmread(path)
            sync()
            secs = time.perf_counter() - t0
        finally:
            utils_native._load = real_load
        read_back("mmread(numpy)", R.astype(torch.float32), secs)
        t0 = time.perf_counter()
        utils_native.build()
        io_runs["native_build_s"] = time.perf_counter() - t0
        check(utils_native.reload(), "the native parser must load")
        t0 = time.perf_counter()
        R = sparse.mmread(path)
        sync()
        secs = time.perf_counter() - t0
        read_back("mmread(native)", R.astype(torch.float32), secs)
        for compressed in (True, False):
            path = os.path.join(tmp, f"poisson_{compressed}.npz")
            sparse.save_npz(path, P, compressed=compressed)
            t0 = time.perf_counter()
            R = sparse.load_npz(path)
            sync()
            secs = time.perf_counter() - t0
            read_back(f"load_npz(compressed={compressed})", R, secs)
    solver_runs["io"] = io_runs
    log({"phase": "solvers_timing", "what": "io, 1024x1024 Poisson",
         "mmwrite_s": io_runs["mmwrite_s"],
         "mmread_numpy_s": io_runs["mmread(numpy)"]["seconds"],
         "mmread_native_s": io_runs["mmread(native)"]["seconds"],
         "load_npz_s": {c: io_runs[f"load_npz(compressed={c})"]["seconds"]
                        for c in (True, False)}, "nvidia_smi": smi_line})
    del R, xp, yp

    # 8. The namespace: scipy's predicates and a scipy fallback returning
    # a tensor on the card.
    check(sparse.issparse(P) and sparse.isspmatrix_csr(P)
          and not sparse.issparse(P.toscipy())
          and not sparse.isspmatrix_csr(P.toscipy()),
          "issparse/isspmatrix_csr on port and scipy matrices")
    small = sparse.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(64, 64),
                         format="csr")
    xs = sparse.linalg.spsolve(small, torch.ones(64, dtype=torch.float64,
                                                 device=dev))
    check(isinstance(xs, torch.Tensor) and xs.device.type == "cuda",
          f"spsolve returned {type(xs)}")
    check(float(torch.linalg.vector_norm(small @ xs - 1.0)) < 1e-10,
          "spsolve's solution")
    del P, small, xs
    torch.cuda.empty_cache()

    solver_seconds = time.perf_counter() - solver_t0
    check(phase10["dia_spmv"] > 0 and phase10["dia_spmm"] > 0
          and phase10["bsr_spmv"] > 0,
          f"the solver phase launched {phase10}")
    log({"phase": "solvers_timing", "what": "phase 10",
         "seconds": solver_seconds, "nvidia_smi": smi_line})
    log({"phase": "main_path_solvers", "nvidia_smi": smi_line,
         "grid": f"{grid}x{grid}", "rows": n, "irregular_rows": irr_rows,
         "runs": solver_runs, "launches": phase10,
         "kernel_vs_plain": kernel_vs_plain, "seconds": solver_seconds})
    csr_phases.close("10")

    # ---- 11. the eigensolvers and csgraph on the main path -----------------
    # Each run from reset_counts(), its card ms by CUDA events around the
    # call (host syncs included), its host fetches through the solvers'
    # one helper, and no scipy fallback (the eigen module's is replaced by
    # one that raises).  S1-S3 on pde_4096 (f32), held to the closed-form
    # spectrum lambda = 4 - 2cos(i pi/4097) - 2cos(j pi/4097): each pair's
    # f64 residual r = |A v - theta v| (|v| = 1) at most SLACK * tol *
    # max(|theta|, 1), theta within r of a closed-form eigenvalue and at
    # most lambda_max + r.  S4 on the 2^20-row block-clustered matrix of
    # phase 6's kind, S5 on a Poisson grid cut to 256x128 (its inner MINRES
    # solves grow with the grid; 256x128 has no double eigenvalue among
    # its smallest), G1 on the R-MAT graph of phase 9 against scipy.
    from scipy.sparse import csgraph as scsg

    from legate_sparse_tpu_torch import eigen as eigen_mod

    spec_t0 = time.perf_counter()
    grid, irr_rows, si_shape, rmat_scale, fw_scale = (4096, 1 << 20,
                                                      (256, 128), 20, 10)
    n = grid * grid
    SLACK = 2.0
    spec_runs, spec_vs_plain = {}, {}
    phase11 = {name: 0 for name in counters}
    fetches = []
    real_fetch = linalg._host_fetch
    real_fallback = eigen_mod._host_fallback

    def counted_fetch(t):
        fetches.append(t.numel())
        return real_fetch(t)

    def no_fallback(name):
        raise RuntimeError(f"chip_smoke: eigen {name} took its scipy "
                           f"fallback on the card's main path")

    def spec_run(fn):
        """``fn()`` from reset_counts(): (out, launches, card ms, host s,
        the sizes of its host fetches); the launches add up in
        ``phase11``."""
        sync()
        reset_counts()
        fetches.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        for k, v in counts.items():
            phase11[k] += v
        return out, counts, start.elapsed_time(end), secs, list(fetches)

    def spec_hold(name, kernel, got, want, bitwise=True):
        err = close(got, want, 1e-6 if bitwise else 1e-5, name)
        same = bool(torch.equal(got, want))
        check(same or not bitwise, f"{name}: kernel and plain version not "
              f"bit for bit equal")
        spec_vs_plain[name] = {"kernel": kernel, "max_abs_err": err,
                               "bitwise": same}

    def spec_hold_dia(name, M, X):
        pk = M._get_dia_pack()
        check(pk is not None, f"{name}: the DIA kernel must take it")
        if X.dim() == 1:
            spec_hold(name, "dia_spmv", dia_kernel.dia_spmv(pk, X),
                      dia_kernel.dia_spmv_plain(pk.rdata, pk.rmask, X,
                                                pk.offsets, pk.shape))
        else:
            check(dia_kernel.spmm_supported(pk, X), f"{name}: dia_spmm")
            spec_hold(name, "dia_spmm", dia_kernel.dia_spmm(pk, X),
                      dia_kernel.dia_spmm_plain(pk.rdata, pk.rmask, X,
                                                pk.offsets, pk.shape))

    def record(name, rec):
        spec_runs[name] = rec
        log({"phase": "spectral_run", "what": name, **rec})

    tgen = torch.Generator(device=dev)
    tgen.manual_seed(11)

    def trandn(*shape):
        return torch.randn(shape, generator=tgen, device=dev)

    def unit_cols(V):
        V = V.to(torch.complex128 if V.is_complex() else torch.float64)
        return V / torch.linalg.vector_norm(V, dim=0, keepdim=True)

    def apply64(M64, V):
        """M64 @ V for a real f64 matrix and a real or complex V."""
        if V.is_complex():
            return torch.complex(M64 @ V.real.contiguous(),
                                 M64 @ V.imag.contiguous())
        return M64 @ V

    # The closed-form spectrum of pde_4096: 2cos(i pi/(N+1)), sorted, and
    # the distance from theta to the nearest 4 - c_i - c_j.
    cos2 = np.sort(2.0 * np.cos(np.arange(1, grid + 1) * np.pi / (grid + 1)))
    lam_max = 4.0 + 4.0 * np.cos(np.pi / (grid + 1))

    def closed_form_gap(theta: float) -> float:
        t = 4.0 - theta - cos2
        idx = np.clip(np.searchsorted(cos2, t), 1, grid - 1)
        return float(np.min(np.minimum(np.abs(cos2[idx] - t),
                                       np.abs(cos2[idx - 1] - t))))

    def judge_pairs(name, theta, V, A64, tol):
        """The S1-S3 checks on (theta, V); returns the per-pair record."""
        U = unit_cols(V)
        R = apply64(A64, U) - U * theta.to(U.dtype)[None, :]
        r = torch.linalg.vector_norm(R, dim=0).cpu().numpy()
        th = theta.cpu().numpy()
        pairs = []
        for i in range(th.shape[0]):
            t = float(np.real(th[i]))
            gap = closed_form_gap(t)
            check(bool(np.isfinite(r[i])), f"{name}: residual {i} not finite")
            check(tol is None or r[i] <= SLACK * tol * max(abs(th[i]), 1.0),
                  f"{name}: pair {i} residual {r[i]} > {SLACK} * {tol} * "
                  f"max(|{th[i]}|, 1)")
            check(gap <= r[i] + 1e-12,
                  f"{name}: theta {t} is {gap} from the closed-form "
                  f"spectrum, its residual {r[i]}")
            check(abs(th[i]) <= lam_max + r[i],
                  f"{name}: |theta| {abs(th[i])} > lambda_max {lam_max} + "
                  f"{r[i]}")
            pairs.append({"theta": (str(complex(th[i])) if np.iscomplexobj(th)
                                    else t),
                          "residual_f64": float(r[i]),
                          "to_closed_form": gap})
        return pairs

    eigen_mod._host_fallback = no_fallback
    linalg._host_fetch = counted_fetch
    try:
        A = sparse.diags([main3, p1, p1, pN, pN], offsets, shape=(n, n),
                         format="csr", dtype=torch.float32)
        A64 = A.astype(torch.float64)
        xs = randx(n)
        A @ xs
        check(A.spmv_path == "dia-kernel", f"pde_4096 @ x took {A.spmv_path}")
        spec_hold_dia("pde_4096 @ x", A, xs)
        for k in (4, 12):
            spec_hold_dia(f"pde_4096 @ X (2^24, {k})", A, trandn(n, k))
        # First use of cuBLAS, cuSOLVER and the generator on a small
        # operator, outside the counted runs.
        warm = sparse.diags([main3[:4096], p1[:4095], p1[:4095]],
                            [0, 1, -1], shape=(4096, 4096), format="csr",
                            dtype=torch.float32)
        linalg.eigsh(warm, k=2, which="LA", tol=1e-1)
        linalg.eigs(warm, k=2, which="LM", tol=1e-1)
        linalg.lobpcg(warm, trandn(4096, 2), maxiter=2)
        del warm

        # S1: eigsh, Lanczos, one dia_spmv a step.
        (w, V), counts, ms, secs, f = spec_run(
            lambda: linalg.eigsh(A, k=4, which="LA", tol=1e-2))
        # A try's one fetch: alphas, betas and breakdown flags (3 m).
        tries = [x // 3 for x in f]
        expect("S1 eigsh", counts, dia_spmv=sum(tries))
        check(w.device == V.device == A.device and V.shape == (n, 4),
              "S1: results on the card")
        record("S1 eigsh(pde_4096, k=4, LA, tol=1e-2)", {
            "m_per_try": tries, "steps": sum(tries),
            "launches": {k: v for k, v in counts.items() if v},
            "host_fetches": len(f), "card_ms": ms, "host_s": secs,
            "ms_per_step": ms / sum(tries),
            "pairs": judge_pairs("S1", w, V, A64, 1e-2)})
        del V
        # One try of the recurrence under the sync debug mode (its one
        # fetch at the end, which the design makes, outside it), and
        # where its time goes: its device time under the profiler, then
        # one SpMV against one step's reorthogonalisation at j = 19, 39,
        # 79.
        op = linalg.make_linear_operator(A)
        v0 = xs / torch.linalg.vector_norm(xs)

        def fetch_outside(t):
            fetches.append(t.numel())
            torch.cuda.set_sync_debug_mode("default")
            try:
                return real_fetch(t)
            finally:
                torch.cuda.set_sync_debug_mode("warn")

        for what, try_, one_fetch in (
                ("Lanczos", lambda: eigen_mod._lanczos(op.matvec, v0, None,
                                                       m=20), 3 * 20),
                ("Arnoldi", lambda: eigen_mod._arnoldi(op.matvec, v0, m=20),
                 21 * 20 + 20)):
            fetches.clear()
            linalg._host_fetch = fetch_outside
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    try_()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    linalg._host_fetch = counted_fetch
            syncs = sorted({str(m.message)[:120] for m in caught
                            if "called a synchronizing" in str(m.message)})
            check(not syncs, f"an {what} try synchronised: {syncs}")
            check(fetches == [one_fetch], f"an {what} try fetched {fetches}")
        try_prof = gmg_app.profile_device(
            lambda: eigen_mod._lanczos(op.matvec, v0, None, m=20), dev,
            top=6)
        Vb = trandn(80, n)
        wb = trandn(n)
        spmv_ms = time_ms(lambda: A @ v0, reps=5)

        def reorth(j):
            Vj = Vb[:j + 1]
            w = wb
            for _ in range(2):
                w = w - Vj.T @ (Vj.conj() @ w)
            return w

        reorth_ms = {j + 1: time_ms(lambda j=j: reorth(j), reps=5)
                     for j in (19, 39, 79)}
        del Vb, wb
        step_split = {
            "spmv_ms": spmv_ms, "reorth_ms_by_rows": reorth_ms,
            "reorth_bound_ms_by_rows": {
                r: 4 * r * n * 4 / HBM_BYTES_PER_S * 1e3 for r in reorth_ms},
            "try_m20_profile": try_prof}
        spec_runs["S1 eigsh(pde_4096, k=4, LA, tol=1e-2)"].update(
            step_split=step_split, syncs_in_a_lanczos_try=0,
            syncs_in_an_arnoldi_try=0)
        log({"phase": "spectral_timing", "what": "Lanczos step, 2^24 rows",
             **step_split, "nvidia_smi": smi_line})
        torch.cuda.empty_cache()

        # S2: eigs, Arnoldi in real arithmetic on the symmetric operator.
        (w, V), counts, ms, secs, f = spec_run(
            lambda: linalg.eigs(A, k=4, which="LM", tol=1e-2))
        # A try's one fetch: the (m + 1, m) Hessenberg and m flags.
        tries = [int(round((1 + x) ** 0.5)) - 1 for x in f]
        check(all(m * (m + 2) == x for m, x in zip(tries, f)),
              f"S2: fetches {f} are not (m + 1) x m Hessenbergs")
        expect("S2 eigs", counts, dia_spmv=sum(tries))
        check(w.is_complex(), "S2: eigs eigenvalues must be complex")
        pairs = judge_pairs("S2", w, V, A64, 1e-2)
        for p_, wi in zip(pairs, w.cpu().numpy()):
            check(abs(wi.imag) <= p_["residual_f64"],
                  f"S2: imaginary part {wi.imag} over the residual")
        record("S2 eigs(pde_4096, k=4, LM, tol=1e-2)", {
            "m_per_try": tries, "steps": sum(tries),
            "launches": {k: v for k, v in counts.items() if v},
            "host_fetches": len(f), "card_ms": ms, "host_s": secs,
            "ms_per_step": ms / sum(tries), "pairs": pairs})
        del w, V
        torch.cuda.empty_cache()

        # S3: lobpcg, one SpMM a block.  tol=1e-15 fixes the work at 20
        # iterations: jax's test accepts a pair once |r| < tol * 10 * n *
        # (|A v| + theta), which at n = 2^24 and the default tol (f32 eps)
        # is ~320, above |A|, after the first iteration.
        X0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (n, 4), dtype=np.float32)).to(dev)
        (w, X), counts, ms, secs, f = spec_run(
            lambda: linalg.lobpcg(A, X0, maxiter=20, largest=True,
                                  tol=1e-15))
        iters = len(f)
        check(iters == 20, f"S3: lobpcg ran {iters} iterations")
        s3_prof = gmg_app.profile_device(
            lambda: linalg.lobpcg(A, X0, maxiter=2, largest=True,
                                  tol=1e-15), dev, top=6)
        expect("S3 lobpcg", counts, dia_spmv=1, dia_spmm=1 + 2 * iters)
        X64 = X.double()
        gram_err = float((X64.T @ X64 - torch.eye(4, dtype=torch.float64,
                                                  device=dev)).abs().max())
        check(gram_err <= 1e-4, f"S3: X orthonormal to {gram_err}")
        rq = (X64 * (A64 @ X64)).sum(0) / (X64 * X64).sum(0)
        rq_err = float(((rq - w.double()).abs() / w.double().abs()).max())
        check(rq_err <= 1e-4, f"S3: theta vs X's Rayleigh quotients "
              f"{rq_err}")
        # lobpcg has no residual tolerance to hold it to: its residuals
        # are held to the closed-form spectrum.
        record("S3 lobpcg(pde_4096, X (2^24, 4), maxiter=20)", {
            "iters": iters, "launches": {k: v for k, v in counts.items()
                                         if v},
            "host_fetches": len(f), "card_ms": ms, "host_s": secs,
            "ms_per_iter": ms / iters, "profile_2_iterations": s3_prof,
            "orthonormality": gram_err,
            "rayleigh_rel_err": rq_err,
            "pairs": judge_pairs("S3", w, X, A64, None)})
        del X0, X, X64, w, A64, xs, v0, op
        torch.cuda.empty_cache()

        # S4: svds on the 2^20-row block-clustered matrix: two SpMVs a
        # step (R and its transpose), U in one SpMM.
        d, i, p = block_clustered(irr_rows, 8, 2)
        R = sparse.csr_array((d, i, p), shape=(irr_rows, irr_rows))
        R_sp = sp.csr_array((d, i, p), shape=(irr_rows, irr_rows))
        xr = randx(irr_rows)
        R @ xr
        check(R.spmv_path == "bsr", f"R @ x took {R.spmv_path}")
        RT = R.T.conj(copy=False)
        RT @ xr
        rt_bsr = RT.spmv_path == "bsr"
        x2d = xr.reshape(-1, 128)
        for name_, M_ in (("R @ x", R), ("R^T @ x", RT))[:1 + rt_bsr]:
            st_ = M_._get_bsr()
            spec_hold(name_, "bsr_spmv", bsr_ops.bsr_spmv(st_, x2d),
                      bsr_ops.bsr_spmv_plain(st_, x2d), bitwise=False)
        Xr = trandn(irr_rows, 4)
        st_ = R._get_bsr()
        spec_hold("R @ X (2^20, 4)", "bsr_spmm", bsr_ops.bsr_spmm(st_, Xr),
                  bsr_ops.bsr_spmm_plain(st_, Xr), bitwise=False)
        del Xr, x2d, st_
        (U, s, Vh), counts, ms, secs, f = spec_run(
            lambda: linalg.svds(R, k=4, tol=1e-2))
        tries = [x // 3 for x in f]
        steps = sum(tries)
        expect("S4 svds", counts,
               bsr_spmv=steps * (2 if rt_bsr else 1) + (1 if rt_bsr else 0),
               bsr_spmm=1)
        t0 = time.perf_counter()
        s_ref = np.sort(sp.linalg.svds(R_sp, k=4, tol=1e-2,
                                       return_singular_vectors=False))
        scipy_s = time.perf_counter() - t0
        R64 = R.astype(torch.float64)
        Vu, Uu = unit_cols(Vh.T), unit_cols(U)
        s64 = s.double()
        fwd = torch.linalg.vector_norm(R64 @ Vu - Uu * s64[None, :], dim=0)
        back = torch.linalg.vector_norm(R64.T @ Uu - Vu * s64[None, :],
                                        dim=0)
        s_np = np.sort(s.cpu().numpy().astype(np.float64))
        rel = np.abs(s_np - s_ref) / s_ref
        for j_ in range(4):
            th = float(s64[j_]) ** 2
            check(float(back[j_]) * float(s64[j_])
                  <= SLACK * 1e-2 * max(th, 1.0),
                  f"S4: R^T u - s v residual {float(back[j_])} for s "
                  f"{float(s64[j_])}")
            check(float(fwd[j_]) <= 1e-4 * float(s64[j_]),
                  f"S4: R v - s u residual {float(fwd[j_])}")
        check(bool(np.all(rel <= 1e-2)), f"S4: s {s_np} vs scipy's {s_ref}")
        record("S4 svds(R 2^20, k=4, tol=1e-2)", {
            "m_per_try": tries, "steps": steps, "transpose_path": RT.spmv_path,
            "launches": {k: v for k, v in counts.items() if v},
            "host_fetches": len(f), "card_ms": ms, "host_s": secs,
            "ms_per_step": ms / steps, "s": s_np.tolist(),
            "s_scipy": s_ref.tolist(), "rel_to_scipy": rel.tolist(),
            "scipy_host_s": scipy_s,
            "residual_Rv_su": fwd.cpu().numpy().tolist(),
            "residual_RTu_sv": back.cpu().numpy().tolist()})
        del R, R_sp, RT, R64, U, s, Vh, Vu, Uu, xr, d, i, p
        torch.cuda.empty_cache()

        # S5: shift-invert at 0 on a Poisson grid, MINRES inside each step.
        nx, ny = si_shape
        ns = nx * ny
        hole = np.ones(ns - 1, np.float32)
        hole[np.arange(1, ny) * nx - 1] = 0.0
        P = sparse.diags([np.full(ns, 4.0, np.float32), -hole, -hole,
                          np.full(ns - nx, -1.0, np.float32),
                          np.full(ns - nx, -1.0, np.float32)],
                         [0, 1, -1, nx, -nx], shape=(ns, ns), format="csr",
                         dtype=torch.float32)
        spec_hold_dia(f"poisson {nx}x{ny} @ x", P, randx(ns))
        spec_hold_dia(f"poisson {nx}x{ny} @ X (k=4)", P, trandn(ns, 4))
        (w, V), counts, ms, secs, f = spec_run(
            lambda: linalg.eigsh(P, k=4, sigma=0.0))
        lam = np.sort((4.0 - 2.0 * np.cos(np.arange(1, nx + 1)[:, None]
                                          * np.pi / (nx + 1))
                       - 2.0 * np.cos(np.arange(1, ny + 1)[None, :]
                                      * np.pi / (ny + 1))).ravel())[:4]
        wn = np.sort(w.cpu().numpy().astype(np.float64))
        si_rel = np.abs(wn - lam) / lam
        check(bool(np.all(si_rel <= 1e-3)),
              f"S5: {wn} vs the closed-form smallest {lam}")
        check(counts["dia_spmv"] > 0 and counts["dia_spmm"] == 1,
              f"S5 launched {counts}")
        record(f"S5 eigsh(poisson {nx}x{ny}, k=4, sigma=0)", {
            "launches": {k: v for k, v in counts.items() if v},
            "host_fetches": len(f), "card_ms": ms, "host_s": secs,
            "eigenvalues": wn.tolist(), "closed_form": lam.tolist(),
            "rel_err": si_rel.tolist()})
        del P, w, V
        torch.cuda.empty_cache()
    finally:
        eigen_mod._host_fallback = real_fallback
        linalg._host_fetch = real_fetch

    # G1: csgraph on the R-MAT graph of phase 9 (scale 20, symmetrised),
    # each against scipy on the host.
    G = sparse.rmat(rmat_scale, nnz_per_row=8, rng=0)
    G_sp = G.toscipy()
    Gs = G + G.T
    def int32_csr(M):
        """scipy's csgraph takes int32 indices only."""
        M = sp.csr_array(M)
        M.sort_indices()
        return sp.csr_array((M.data, M.indices.astype(np.int32),
                             M.indptr.astype(np.int32)), shape=M.shape)

    Gs_sp = int32_csr(G_sp + G_sp.T)
    nG = Gs.shape[0]
    graph_runs = {}

    def graph_run(name, card_fn, host_fn):
        out, counts, ms, secs, _ = spec_run(card_fn)
        t0 = time.perf_counter()
        ref = host_fn()
        host_s = time.perf_counter() - t0
        graph_runs[name] = {"card_ms": ms, "host_s": secs,
                            "scipy_host_s": host_s,
                            "launches": {k: v for k, v in counts.items()
                                         if v}}
        return out, ref

    (ncc, labels), (ncc_ref, labels_ref) = graph_run(
        "connected_components",
        lambda: sparse.csgraph.connected_components(Gs, directed=False),
        lambda: scsg.connected_components(Gs_sp, directed=False))
    check(ncc == ncc_ref and np.array_equal(labels.cpu().numpy(), labels_ref),
          f"connected_components: {ncc} vs scipy {ncc_ref}")
    graph_runs["connected_components"]["components"] = ncc
    L, L_ref = graph_run(
        "laplacian(normed)",
        lambda: sparse.csgraph.laplacian(Gs, normed=True),
        lambda: scsg.laplacian(Gs_sp, normed=True))
    L_ref = sp.csr_array(L_ref)
    L_ref.sum_duplicates()
    L_ref.sort_indices()
    check(np.array_equal(L.indptr.cpu().numpy(), L_ref.indptr)
          and np.array_equal(L.indices.cpu().numpy(), L_ref.indices),
          "laplacian: pattern differs from scipy's")
    lap_err = float(np.max(np.abs(L.data.cpu().numpy() - L_ref.data)))
    check(lap_err <= 1e-12, f"laplacian values vs scipy: {lap_err}")
    xg = randx(nG, torch.float64)
    xgn = xg.cpu().numpy()
    yL = L @ xg
    lap_dot_err = within(yL, L_ref @ xgn, abs(L_ref) @ np.abs(xgn), 1e-12,
                         "laplacian @ x")
    graph_runs["laplacian(normed)"].update(
        path=L.spmv_path, max_abs_err=lap_err, dot_max_abs_err=lap_dot_err)
    src = np.sort(np.random.default_rng(2).choice(nG, 8, replace=False))
    (dist, pred), dist_ref = graph_run(
        "dijkstra(8 sources)",
        lambda: sparse.csgraph.dijkstra(Gs, indices=src,
                                        return_predecessors=True),
        lambda: scsg.dijkstra(Gs_sp, indices=src))
    dist_h = dist.cpu().numpy()
    fin = np.isfinite(dist_ref)
    check(np.array_equal(np.isfinite(dist_h), fin), "dijkstra: infinities")
    dij_rel = float(np.max(np.abs(dist_h[fin] - dist_ref[fin])
                           / np.maximum(np.abs(dist_ref[fin]), 1e-300)))
    check(dij_rel <= 1e-12, f"dijkstra vs scipy: max rel {dij_rel}")
    # Every reached non-source node's predecessor edge exists and is
    # tight: dist[p] + w(p, j) == dist[j], the weight looked up in Gs's
    # canonical (row, col) keys on the card.
    keys = Gs._get_row_ids().long() * nG + Gs.indices.long()
    has = pred != -9999
    si_, sj_ = torch.nonzero(has, as_tuple=True)
    pp = pred[si_, sj_].long()
    at = torch.searchsorted(keys, pp * nG + sj_)
    at = torch.clamp(at, max=keys.numel() - 1)
    check(bool((keys[at] == pp * nG + sj_).all()),
          "dijkstra: a predecessor edge is not in the graph")
    tight = (dist[si_, pp] + Gs.data[at] - dist[si_, sj_]).abs()
    pred_err = float((tight / dist[si_, sj_].abs().clamp_min(1e-300)).max())
    check(pred_err <= 1e-12, f"dijkstra: predecessors not tight {pred_err}")
    graph_runs["dijkstra(8 sources)"].update(
        max_rel_err=dij_rel, reached=int(fin.sum()),
        predecessors_checked=int(si_.numel()), predecessor_rel_err=pred_err)
    del dist, pred, keys, has, si_, sj_, pp, at, tight, dist_h
    T, T_ref = graph_run(
        "minimum_spanning_tree",
        lambda: sparse.csgraph.minimum_spanning_tree(Gs),
        lambda: scsg.minimum_spanning_tree(Gs_sp))
    t_sum, t_ref = float(T.data.sum()), float(T_ref.sum())
    check(T.nnz == T_ref.nnz and abs(t_sum - t_ref) <= 1e-9 * t_ref,
          f"minimum_spanning_tree: {T.nnz} edges weighing {t_sum} vs "
          f"scipy's {T_ref.nnz}, {t_ref}")
    graph_runs["minimum_spanning_tree"].update(edges=T.nnz, weight=t_sum,
                                               weight_scipy=t_ref)
    H = sparse.rmat(fw_scale, nnz_per_row=8, rng=0)
    Hs = H + H.T
    Hs_sp = int32_csr(Hs.toscipy())
    D, D_ref = graph_run(
        "floyd_warshall(rmat 10)",
        lambda: sparse.csgraph.floyd_warshall(Hs),
        lambda: scsg.floyd_warshall(Hs_sp))
    Dh = D.cpu().numpy()
    finD = np.isfinite(D_ref)
    check(np.array_equal(np.isfinite(Dh), finD), "floyd_warshall: inf")
    fw_rel = float(np.max(np.abs(Dh[finD] - D_ref[finD])
                          / np.maximum(np.abs(D_ref[finD]), 1e-300)))
    check(fw_rel <= 1e-12, f"floyd_warshall vs scipy: max rel {fw_rel}")
    graph_runs["floyd_warshall(rmat 10)"]["max_rel_err"] = fw_rel
    record("G1 csgraph(rmat 20)", {"nodes": nG, "nnz": Gs.nnz,
                                   "runs": graph_runs})
    del G, G_sp, Gs, Gs_sp, L, L_ref, xg, yL, T, T_ref, H, Hs, Hs_sp, D
    torch.cuda.empty_cache()

    spec_seconds = time.perf_counter() - spec_t0
    check(phase11["dia_spmv"] > 0 and phase11["dia_spmm"] > 0
          and phase11["bsr_spmv"] > 0,
          f"the spectral phase launched {phase11}")
    log({"phase": "main_path_spectral", "nvidia_smi": smi_line,
         "runs": spec_runs, "launches": phase11,
         "kernel_vs_plain": spec_vs_plain, "seconds": spec_seconds})

    csr_phases.close("11")

    # ---- 12. compressed storage, refine= and the obs core -------------------
    # pde_4096 and phase 6's 2^20 block-clustered kind in compressed storage
    # (csr_array.compress: bf16 values; 2^24 and 2^20 columns keep int32
    # indices).  C1/C2: a bf16 operand runs the bf16 kernels, each against
    # its plain version; an f32 operand takes the plain widening routes and
    # launches nothing.  C3: a 32,768-column matrix of the same kind takes
    # int16 indices into the BSR kernels.  C4: refine= on phase 10's
    # operators at rtol 1e-5 beside the unrefined solves.  C1-C4 run with
    # tracing on, and the obs counters are held to the dots, solver SpMVs
    # and host fetches the runs make; then the trace and OpenMetrics
    # round-trip.  Timings come after, tracing off: the bf16 kernels and
    # the widening routes, and C5, the sliced ELL on phase 9's R-MAT graph
    # (flat ELL is over budget on its skewed rows) against csr-rowids.
    from legate_sparse_tpu_torch import obs
    from legate_sparse_tpu_torch.obs import latency as obs_lat
    from legate_sparse_tpu_torch.settings import settings as tsettings

    comp_t0 = time.perf_counter()
    grid, irr_rows, small_rows, rmat_scale, kB = 4096, 1 << 20, 1 << 15, 20, 16
    n = grid * grid
    phase12 = {name: 0 for name in counters}
    bf16_launches = {name: 0 for name in counters}
    comp_runs, comp_vs_plain = {}, {}
    dots = {"spmv": 0, "spmm": 0}

    def dot(M, v):
        """``M @ v``, counted: the obs check holds ``op.spmv`` and
        ``op.spmm`` to these and the solvers' SpMVs."""
        dots["spmv" if v.dim() == 1 else "spmm"] += 1
        return M @ v

    def comp_run(fn, bf16=False):
        """``fn()`` from reset_counts(): (out, launches, card ms); the
        launches add up in ``phase12`` (and ``bf16_launches``)."""
        sync()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        counts = read_counts()
        for k, v in counts.items():
            phase12[k] += v
            if bf16:
                bf16_launches[k] += v
        return out, counts, start.elapsed_time(end)

    def expect12(name, counts, **want):
        full = {k: want.get(k, 0) for k in counters}
        check(counts == full, f"{name} launched {counts}, expected {full}")

    def comp_hold(name, kernel, got, want, bitwise):
        err = close(got, want, 1e-6 if bitwise else 1e-5, name)
        same = bool(torch.equal(got, want))
        check(same or not bitwise, f"{name}: kernel and plain version not "
              f"bit for bit equal")
        comp_vs_plain[name] = {"kernel": kernel, "max_abs_err": err,
                               "bitwise": same}
        return err

    # Phase 10's operators for C4, and warm-up solves (the first use of
    # each elementwise kernel costs tens of ms once), before the counts.
    hole = np.ones(n - 1, np.float32)
    hole[np.arange(1, grid) * grid - 1] = 0.0
    far = np.full(n - grid, -1.0, np.float32)
    ones = np.ones(n, np.float32)
    five = [0, 1, -1, grid, -grid]
    step = sparse.diags([5.0 * ones, -hole, -hole, far, far], five,
                        shape=(n, n), format="csr", dtype=torch.float32)
    convdiff = sparse.diags([5.0 * ones, -0.5 * hole, -1.5 * hole, far, far],
                            five, shape=(n, n), format="csr",
                            dtype=torch.float32)
    step64, cd64 = step.astype(torch.float64), convdiff.astype(torch.float64)
    x_true = randx(n)
    b_step, b_cd = step @ x_true, convdiff @ x_true
    b_step64 = step64 @ x_true.double()
    linalg.cg(step, b_step, maxiter=2)
    linalg.cg(step64, b_step64, maxiter=2)
    linalg.gmres(convdiff, b_cd, restart=2, maxiter=2)
    linalg.cg(step, b_step, maxiter=2, refine=1)

    obs.reset_all()
    obs.enable()

    # C1. pde_4096 compressed.
    A = sparse.diags([main3, p1, p1, pN, pN], offsets, shape=(n, n),
                     format="csr", dtype=torch.float32)
    Ab = A.compress()
    wide = torch.int32 if n > 1 << 15 else torch.int16
    check(Ab.dtype == torch.bfloat16 and Ab.indices.dtype == wide,
          f"pde_4096 compressed to {Ab.dtype}, {Ab.indices.dtype}")
    xb = randx(n, torch.bfloat16)
    yb, counts, ms = comp_run(lambda: dot(Ab, xb), bf16=True)
    check(Ab.spmv_path == "dia-kernel" and yb.dtype == torch.bfloat16,
          f"Ab @ xb took {Ab.spmv_path}, {yb.dtype}")
    expect12("Ab @ xb", counts, dia_spmv=1)
    pkb = Ab._get_dia_pack()
    check(pkb.rmask is None and pkb.rdata.dtype == torch.bfloat16,
          "the compressed band is bf16 without a hole mask")
    comp_hold("pde_4096 bf16 @ xb", "dia_spmv", yb,
              dia_kernel.dia_spmv_plain(pkb.rdata, None, xb, pkb.offsets,
                                        pkb.shape), True)
    comp_runs["Ab @ xb"] = {"path": Ab.spmv_path, "card_ms": ms,
                            "launches": {"dia_spmv": 1}}
    x = randx(n)
    y, counts, ms = comp_run(lambda: dot(Ab, x))
    check(Ab.spmv_path == "dia-torch" and y.dtype == torch.float32,
          f"Ab @ x took {Ab.spmv_path}, {y.dtype}")
    expect12("Ab @ x (widening)", counts)
    y32 = dot(A, x)
    comp_runs["Ab @ x"] = {
        "path": Ab.spmv_path, "card_ms": ms, "launches": {},
        "max_abs_err_vs_f32": close(y, y32, 1e-6, "Ab @ x vs A @ x"),
        "bitwise_vs_f32": bool(torch.equal(y, y32))}
    Xb = randX(n, kB, torch.bfloat16)
    Yb, counts, ms = comp_run(lambda: dot(Ab, Xb), bf16=True)
    check(Ab.spmm_path == "dia-kernel" and Yb.dtype == torch.bfloat16,
          f"Ab @ Xb took {Ab.spmm_path}")
    expect12("Ab @ Xb", counts, dia_spmm=1)
    comp_hold("pde_4096 bf16 @ Xb (k=16)", "dia_spmm", Yb,
              dia_kernel.dia_spmm_plain(pkb.rdata, None, Xb, pkb.offsets,
                                        pkb.shape), True)
    comp_runs["Ab @ Xb"] = {"path": Ab.spmm_path, "card_ms": ms,
                            "launches": {"dia_spmm": 1}}
    del Yb
    X = randX(n, kB)
    Y, counts, ms = comp_run(lambda: dot(Ab, X))
    check(Ab.spmm_path == "dia-torch" and Y.dtype == torch.float32,
          f"Ab @ X took {Ab.spmm_path}")
    expect12("Ab @ X (widening)", counts)
    Y32 = dot(A, X)
    comp_runs["Ab @ X"] = {
        "path": Ab.spmm_path, "card_ms": ms, "launches": {},
        "max_abs_err_vs_f32": close(Y, Y32, 1e-6, "Ab @ X vs A @ X"),
        "bitwise_vs_f32": bool(torch.equal(Y, Y32))}
    del Y, Y32
    torch.cuda.empty_cache()

    # C2. The 2^20-row block-clustered matrix compressed.
    d, i, p = block_clustered(irr_rows, 8, 2)
    R = sparse.csr_array((d, i, p), shape=(irr_rows, irr_rows))
    Rb = R.compress()
    check(Rb.indices.dtype == (torch.int32 if irr_rows > 1 << 15
                               else torch.int16),
          f"2^20 columns keep int32, got {Rb.indices.dtype}")
    xrb = randx(irr_rows, torch.bfloat16)
    yrb, counts, ms = comp_run(lambda: dot(Rb, xrb), bf16=True)
    check(Rb.spmv_path == "bsr", f"Rb @ xb took {Rb.spmv_path}")
    expect12("Rb @ xb", counts, bsr_spmv=1)
    stb = Rb._get_bsr()
    xrb2d = xrb.reshape(-1, 128)
    comp_hold("irregular bf16 @ xb", "bsr_spmv", bsr_ops.bsr_spmv(stb, xrb2d),
              bsr_ops.bsr_spmv_plain(stb, xrb2d), False)
    comp_runs["Rb @ xb"] = {"path": Rb.spmv_path, "card_ms": ms,
                            "launches": {"bsr_spmv": 1}}
    Xrb = randX(irr_rows, kB, torch.bfloat16)
    Yrb, counts, ms = comp_run(lambda: dot(Rb, Xrb), bf16=True)
    check(Rb.spmm_path == "bsr", f"Rb @ Xb took {Rb.spmm_path}")
    expect12("Rb @ Xb", counts, bsr_spmm=1)
    comp_hold("irregular bf16 @ Xb (k=16)", "bsr_spmm",
              bsr_ops.bsr_spmm(stb, Xrb), bsr_ops.bsr_spmm_plain(stb, Xrb),
              False)
    comp_runs["Rb @ Xb"] = {"path": Rb.spmm_path, "card_ms": ms,
                            "launches": {"bsr_spmm": 1}}
    del Yrb
    xr = randx(irr_rows)
    width = int((R.indptr[1:] - R.indptr[:-1]).max())
    want_path = ("ell-bf16" if spmv_ops.ell_within_budget(
        irr_rows, width, R.nnz, tsettings.ell_max_expand)
        else "csr-rowids-bf16")
    yr, counts, ms = comp_run(lambda: dot(Rb, xr))
    check(Rb.spmv_path == want_path, f"Rb @ x took {Rb.spmv_path}, the "
          f"JAX package's rules pick {want_path}")
    expect12("Rb @ x (widening)", counts)
    Rr = Rb.astype_storage(values="float32")    # the rounded values, f32
    yr32 = dot(Rr, xr)
    check(Rr.spmv_path == "bsr", f"Rr @ x took {Rr.spmv_path}")
    comp_runs["Rb @ x"] = {
        "path": Rb.spmv_path, "card_ms": ms, "launches": {},
        "row_width": width,
        "max_abs_err_vs_f32": close(yr, yr32, 1e-5, "Rb @ x vs f32")}

    # C3. int16 indices into the BSR kernels: 32,768 columns.
    d16, i16, p16 = block_clustered(small_rows, 8, 2)
    R16 = sparse.csr_array((d16, i16, p16),
                           shape=(small_rows, small_rows)).compress()
    check(R16.indices.dtype == torch.int16, "32,768 columns take int16")
    x16 = randx(small_rows, torch.bfloat16)
    X16 = randX(small_rows, kB, torch.bfloat16)
    y16, counts, ms = comp_run(lambda: dot(R16, x16), bf16=True)
    check(R16.spmv_path == "bsr", f"R16 @ xb took {R16.spmv_path}")
    expect12("R16 @ xb", counts, bsr_spmv=1)
    st16 = R16._get_bsr()
    check(st16.indices.dtype == torch.int16, "the BSR structure reads int16")
    comp_hold("int16 bf16 @ xb", "bsr_spmv",
              bsr_ops.bsr_spmv(st16, x16.reshape(-1, 128)),
              bsr_ops.bsr_spmv_plain(st16, x16.reshape(-1, 128)), False)
    Y16, counts2, ms2 = comp_run(lambda: dot(R16, X16), bf16=True)
    check(R16.spmm_path == "bsr", f"R16 @ Xb took {R16.spmm_path}")
    expect12("R16 @ Xb", counts2, bsr_spmm=1)
    comp_hold("int16 bf16 @ Xb (k=16)", "bsr_spmm", bsr_ops.bsr_spmm(st16, X16),
              bsr_ops.bsr_spmm_plain(st16, X16), False)
    # The int16 instantiations read what the int32 ones read, in the same
    # order: the same bits.
    st32 = R16.astype_storage(indices="int32")._get_bsr()
    check(torch.equal(bsr_ops.bsr_spmv(st16, x16.reshape(-1, 128)),
                      bsr_ops.bsr_spmv(st32, x16.reshape(-1, 128)))
          and torch.equal(bsr_ops.bsr_spmm(st16, X16),
                          bsr_ops.bsr_spmm(st32, X16)),
          "int16 and int32 BSR kernels differ")
    comp_runs["R16 @ xb, @ Xb"] = {"rows": small_rows, "nnz": R16.nnz,
                                   "index_dtype": "int16",
                                   "card_ms": [ms, ms2]}
    del y16, Y16, d16, i16, p16, st32

    # C4. refine= on phase 10's operators, beside the unrefined solves.
    rtol = 1e-5
    solver_spmvs = 0
    fetches = []
    real_fetch = linalg._host_fetch

    def counted_fetch(t):
        fetches.append(t.numel())
        return real_fetch(t)

    def solve(name, fn, A64, b, kernel_spmvs, res_limit):
        """One solve from reset_counts() with tracing on: its SpMVs,
        fetches and launches from the spans and counters it leaves."""
        nonlocal solver_spmvs
        n_rec = len(obs.records())
        snap0 = obs.counters.snapshot("transfer.host_sync.")
        fetches.clear()
        linalg._host_fetch = counted_fetch
        try:
            (x_, it), counts, ms = comp_run(fn)
        finally:
            linalg._host_fetch = real_fetch
        recs = obs.records()[n_rec:]
        snap1 = obs.counters.snapshot("transfer.host_sync.")
        delta = {k.rsplit(".", 1)[1]: v - snap0.get(k, 0)
                 for k, v in snap1.items() if v != snap0.get(k, 0)}
        cg_mv = sum(r["attrs"]["iters"] + 1 for r in recs
                    if r["name"] == "cg")
        cycles = sum(1 for r in recs if r["name"] == "gmres.cycle")
        restart_ = next((r["attrs"]["restart"] for r in recs
                         if r["name"] == "gmres.cycle"), 0)
        gm_mv = (cycles * (restart_ + 1)
                 + delta.get("gmres_conv", 0) - cycles)
        refine_cycles = delta.get("cg_refine", 0) + delta.get(
            "gmres_refine", 0)
        spmvs = cg_mv + gm_mv + refine_cycles
        solver_spmvs += spmvs
        check(sum(delta.values()) == len(fetches),
              f"{name}: transfer.host_sync.* {delta} against "
              f"{len(fetches)} fetches")
        want = kernel_spmvs(cg_mv, gm_mv, refine_cycles)
        expect12(name, counts, dia_spmv=want)
        res = rel_norm(dot(A64, x_.double()), b)
        err = rel_norm(x_, x_true)
        check(bool(torch.isfinite(x_).all()), f"{name}: x not finite")
        check(res <= res_limit, f"{name}: true relative residual {res} > "
              f"{res_limit}")
        check(err <= 1e-3, f"{name}: relative error to x_true {err}")
        comp_runs[name] = {"iters": int(it), "refine_cycles": refine_cycles,
                           "host_sync": delta, "host_fetches": len(fetches),
                           "spmvs": spmvs, "rel_residual_f64": res,
                           "rel_error_to_x_true": err, "card_ms": ms,
                           "launches": {k: v for k, v in counts.items()
                                        if v}}

    def rel_norm(v, ref) -> float:
        return float(torch.linalg.vector_norm(v.double() - ref.double())
                     / torch.linalg.vector_norm(ref.double()))

    # The f64 system: inner f32 solves through the f32 DIA kernel; the
    # outer f64 residuals and the unrefined f64 solve through dia-torch.
    solve("cg(step f64, refine)", lambda: linalg.cg(
        step64, b_step64, rtol=rtol, refine="auto"), step64, b_step64,
        lambda cg_mv, gm_mv, rc: cg_mv, 1.05 * rtol)
    solve("cg(step f64)", lambda: linalg.cg(step64, b_step64, rtol=rtol),
          step64, b_step64, lambda cg_mv, gm_mv, rc: 0, 2 * rtol)
    # The f32 systems: inner bf16 solves take the widening routes; the
    # outer f32 residuals the f32 DIA kernel.
    solve("cg(step f32, refine)", lambda: linalg.cg(
        step, b_step, rtol=rtol, refine="auto"), step64, b_step,
        lambda cg_mv, gm_mv, rc: rc, 1.05 * rtol)
    solve("cg(step f32)", lambda: linalg.cg(step, b_step, rtol=rtol),
          step64, b_step, lambda cg_mv, gm_mv, rc: cg_mv, 2 * rtol)
    solve("gmres(convdiff f32, refine)", lambda: linalg.gmres(
        convdiff, b_cd, rtol=rtol, restart=20, refine="auto"), cd64, b_cd,
        lambda cg_mv, gm_mv, rc: rc, 1.05 * rtol)
    solve("gmres(convdiff f32)", lambda: linalg.gmres(
        convdiff, b_cd, rtol=rtol, restart=20), cd64, b_cd,
        lambda cg_mv, gm_mv, rc: gm_mv, 2 * rtol)
    for name in ("cg(step f64, refine)", "cg(step f32, refine)",
                 "gmres(convdiff f32, refine)"):
        check(comp_runs[name]["refine_cycles"] >= 1,
              f"{name}: no refinement cycle")
        check(comp_runs[name]["host_sync"][
            name.split("(")[0] + "_refine"] == comp_runs[name][
                "refine_cycles"], f"{name}: one refine fetch a cycle")

    # C6. The obs core: the counters against the calls C1-C4 made, the
    # histograms, the trace, OpenMetrics and the memory sample.
    csnap = obs.counters.snapshot()
    op_spmv, op_spmm = csnap.get("op.spmv", 0), csnap.get("op.spmm", 0)
    check(op_spmv == dots["spmv"] + solver_spmvs,
          f"op.spmv {op_spmv} against {dots['spmv']} direct SpMVs and "
          f"{solver_spmvs} in the solvers")
    check(op_spmm == dots["spmm"], f"op.spmm {op_spmm} against "
          f"{dots['spmm']}")
    hists = obs_lat.snapshot("lat.")
    lat_spmv = sum(h.count for k, h in hists.items()
                   if k.startswith("lat.spmv."))
    check(lat_spmv == op_spmv, f"lat.spmv.* {lat_spmv} against op.spmv "
          f"{op_spmv}")
    recs = obs.records()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "phase12.trace.json")
        n_events = obs.write_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    check(n_events == len(doc["traceEvents"]) == len(recs),
          f"chrome trace: {n_events} events for {len(recs)} records")
    check({"spmv", "cg", "cg.refine", "gmres.cycle", "gmres.refine",
           "kernel.dia_spmv"} <= names, f"chrome trace names {sorted(names)}")
    check(doc["otherData"]["counters"]["op.spmv"] == op_spmv,
          "chrome trace counters")
    om_counters, om_hists = obs.export.parse_openmetrics(
        obs.snapshot_openmetrics())
    csnap = obs.counters.snapshot()
    check(om_counters == csnap, "OpenMetrics counters round trip")
    check({k: h["count"] for k, h in om_hists.items()}
          == {k: h.count for k, h in obs_lat.snapshot().items()},
          "OpenMetrics histogram counts round trip")
    mem = obs.memory.snapshot()
    alloc_mb = round(torch.cuda.memory_allocated() / 2**20, 2)
    peak_mb = round(torch.cuda.max_memory_allocated() / 2**20, 2)
    check(mem.get("device_mb") == alloc_mb
          and mem.get("device_peak_mb") == peak_mb,
          f"memory.snapshot {mem} against {alloc_mb}, {peak_mb} MiB")
    obs.disable()

    def obs_cost_us(traced: bool, reps: int = 20000) -> float:
        """Host us that the dot's instrumentation adds a call: the
        counter handle, the timer and the span, with nothing inside."""
        obs.enable() if traced else obs.disable()
        name = "lat.spmv." + obs_lat.shape_bucket(n)
        t0 = time.perf_counter()
        for _ in range(reps):
            obs.counters.handle("op.spmv").inc()
            with obs_lat.timer(name), obs.span("spmv") as sp_:
                if sp_ is not None:
                    sp_.set(path="dia-kernel", rows=n)
        obs.disable()
        return (time.perf_counter() - t0) / reps * 1e6

    obs_check = {"op_spmv": op_spmv, "direct_spmv": dots["spmv"],
                 "solver_spmv": solver_spmvs, "op_spmm": op_spmm,
                 "lat_spmv_count": lat_spmv, "records": len(recs),
                 "trace_events": n_events,
                 "openmetrics_counters": len(om_counters),
                 "openmetrics_histograms": len(om_hists), "memory": mem,
                 "host_us_per_dot_off": obs_cost_us(False),
                 "host_us_per_dot_traced": obs_cost_us(True)}
    obs.reset_all()
    del step, convdiff, step64, cd64, x_true, b_step, b_cd, b_step64
    torch.cuda.empty_cache()

    # Timings (tracing off): each bf16 kernel at its phase-12 shape beside
    # its plain version, its bound and the library's call where PyTorch
    # has one for bf16 on this card.
    def library_ms(fn):
        """(ms, None) of one torch.sparse call, or (None, the reason)
        where PyTorch offers no such call for bf16 here: a yardstick the
        port never calls, so its absence fails nothing."""
        try:
            fn()
            sync()
        except (RuntimeError, NotImplementedError) as e:
            return None, str(e).splitlines()[0][:200]
        return time_ms(fn), None

    bf16_rows = []

    def bf16_row(name, source, replaces, kernel_fn, plain_fn, lib_fn,
                 nbytes, nops, shape, plain_reps=REPS):
        lib, lib_err = library_ms(lib_fn)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "dtype": "bfloat16",
               "launches": bf16_launches[name],
               "max_abs_err": max(h["max_abs_err"]
                                  for h in comp_vs_plain.values()
                                  if h["kernel"] == name),
               "ms": time_ms(kernel_fn),
               "plain_ms": time_ms(plain_fn, reps=plain_reps),
               **bound(nbytes, nops), "library_ms": lib,
               "shape": {**shape, "bytes": nbytes}}
        if lib_err:
            row["library_error"] = lib_err
        bf16_rows.append(row)
        log({"phase": "timing_bf16", **row, "nvidia_smi": smi_line})

    nd = len(pkb.offsets)
    A_lib_b = torch.sparse_csr_tensor(A.indptr, A.indices.to(torch.int64),
                                      Ab.data, size=A.shape,
                                      check_invariants=False)
    nb_spmv = nd * n * 2 + 2 * n + 2 * n
    check(nb_spmv == Ab.spmv_traffic_bytes(xb, path="dia-kernel")
          == 234_881_024, f"bf16 dia_spmv bytes {nb_spmv}")
    bf16_row("dia_spmv", "legate_sparse_tpu_torch/csrc/dia_spmv.cu",
             "legate_sparse_tpu/ops/pallas_dia.py:312",
             lambda: dia_kernel.dia_spmv(pkb, xb),
             lambda: dia_kernel.dia_spmv_plain(pkb.rdata, None, xb,
                                               pkb.offsets, pkb.shape),
             lambda: A_lib_b @ xb, nb_spmv, 2 * nd * n,
             {"rows": n, "diags": nd, "masked": False,
              "variant": ("16-byte" if dia_kernel.spmv_vector_ok(pkb)
                          else "scalar")})
    nb_spmm = nd * n * 2 + 2 * 2 * n * kB
    bf16_row("dia_spmm", "legate_sparse_tpu_torch/csrc/dia_spmm.cu",
             "legate_sparse_tpu/ops/pallas_dia.py:417",
             lambda: dia_kernel.dia_spmm(pkb, Xb),
             lambda: dia_kernel.dia_spmm_plain(pkb.rdata, None, Xb,
                                               pkb.offsets, pkb.shape),
             lambda: A_lib_b @ Xb, nb_spmm, 2 * nd * n * kB,
             {"rows": n, "diags": nd, "k": kB, "masked": False,
              "variant": ("16-byte" if dia_kernel.spmm_vector_ok(pkb, Xb)
                          else "scalar")})
    widening = {
        "Ab @ x (dia-torch)": {"ms": time_ms(lambda: Ab @ x),
                               "bytes": Ab.spmv_traffic_bytes(
                                   x, path="dia-torch")},
        "Ab @ X (dia-torch, k=16)": {"ms": time_ms(lambda: Ab @ X, reps=5),
                                     "bytes": Ab.spmv_traffic_bytes(
                                         X, path="dia-torch")},
        "Rb @ x (" + want_path + ")": {
            "ms": time_ms(lambda: Rb @ xr),
            "bytes": Rb.spmv_traffic_bytes(xr, path=want_path)},
    }
    for w in widening.values():
        w.update(bound(w["bytes"], 0))
    check(widening["Ab @ x (dia-torch)"]["bytes"] == 301_989_888,
          "the widening DIA route's bytes")
    del A_lib_b, Xb, X
    torch.cuda.empty_cache()
    R_lib_b = torch.sparse_csr_tensor(Rb.indptr, Rb.indices.to(torch.int64),
                                      Rb.data, size=Rb.shape,
                                      check_invariants=False)
    csr_b = (Rb.nnz * (2 + Rb.indices.element_size())
             + Rb.indptr.numel() * 8 + stb.nblocks * 4 + (stb.nbr + 1) * 8)
    bf16_row("bsr_spmv", "legate_sparse_tpu_torch/csrc/bsr_spmv.cu",
             "legate_sparse_tpu/ops/bsr.py:143",
             lambda: bsr_ops.bsr_spmv(stb, xrb2d),
             lambda: bsr_ops.bsr_spmv_plain(stb, xrb2d),
             lambda: R_lib_b @ xrb, csr_b + 2 * irr_rows + 4 * irr_rows,
             2 * Rb.nnz, {"rows": irr_rows, "blocks": stb.nblocks,
                          "nnz": Rb.nnz}, plain_reps=5)
    bf16_row("bsr_spmm", "legate_sparse_tpu_torch/csrc/bsr_spmm.cu",
             "legate_sparse_tpu/ops/bsr.py:198",
             lambda: bsr_ops.bsr_spmm(stb, Xrb),
             lambda: bsr_ops.bsr_spmm_plain(stb, Xrb),
             lambda: R_lib_b @ Xrb,
             csr_b + 2 * irr_rows * kB + 4 * irr_rows * kB,
             2 * Rb.nnz * kB, {"rows": irr_rows, "blocks": stb.nblocks,
                               "k": kB, "nnz": Rb.nnz}, plain_reps=5)
    del R_lib_b, A, Ab, pkb, xb, x, y, y32, yb, R, Rb, Rr, stb, xrb, xrb2d
    del Xrb, xr, yr, yr32, yrb, R16, st16, x16, X16, d, i, p
    torch.cuda.empty_cache()

    # C5. The sliced ELL on the R-MAT graph of phase 9 (f64), and its
    # f32-accumulation variant on the graph's bf16 copy, against
    # csr-rowids on the same inputs.
    G = sparse.rmat(rmat_scale, nnz_per_row=8, rng=0)
    g_rows = G.shape[0]
    check(G._get_ell() is None, "flat ELL must be over budget on R-MAT")
    t0 = time.perf_counter()
    bins = G._get_sliced_ell()
    sync()
    pack_s = time.perf_counter() - t0
    xg = randx(g_rows).double()
    g_rid = G._get_row_ids()
    ys = spmv_ops.sliced_ell_spmv(bins, xg, g_rows)
    yg = spmv_ops.csr_spmv_rowids(G.data, G.indices, g_rid, xg, g_rows)
    sliced_err = close(ys, yg, 1e-12, "sliced ELL vs csr-rowids (f64)")
    Gb = G.compress()
    bins_b = Gb._get_sliced_ell()
    xg32 = xg.float()
    ysb = spmv_ops.sliced_ell_spmv_f32acc(bins_b, xg32, g_rows)
    ygb = spmv_ops.csr_spmv_rowids_f32acc(Gb.data, Gb.indices, g_rid, xg32,
                                          g_rows)
    sliced_b_err = close(ysb, ygb, 1e-5,
                         "sliced ELL f32acc vs csr-rowids f32acc (bf16)")
    sliced = {
        "nodes": g_rows, "nnz": G.nnz, "bins": [int(b[0].shape[1])
                                                for b in bins],
        "bin_rows": [int(b[0].shape[0]) for b in bins], "pack_s": pack_s,
        "padded_slots": sum(b[0].numel() for b in bins),
        "f64": {"ms": time_ms(lambda: spmv_ops.sliced_ell_spmv(
                    bins, xg, g_rows), reps=5),
                "csr_rowids_kernel_ms": time_ms(
                    lambda: spmv_ops.csr_spmv_rowids(
                        G.data, G.indices, None, xg, g_rows,
                        lengths=G._get_row_lengths(),
                        serial=G._serial_rows(), offsets=G.indptr,
                        schedule=G._get_csr_schedule()), reps=5),
                "bytes": G.spmv_traffic_bytes(xg, path="sliced-ell"),
                "max_abs_err": sliced_err},
        "bf16_f32acc": {
            "ms": time_ms(lambda: spmv_ops.sliced_ell_spmv_f32acc(
                bins_b, xg32, g_rows), reps=5),
            "csr_rowids_ms": time_ms(
                lambda: spmv_ops.csr_spmv_rowids_f32acc(
                    Gb.data, Gb.indices, g_rid, xg32, g_rows), reps=5),
            "bytes": Gb.spmv_traffic_bytes(xg32, path="sliced-ell"),
            "max_abs_err": sliced_b_err}}
    for part in (sliced["f64"], sliced["bf16_f32acc"]):
        part.update(bound(part["bytes"], 0))
    del G, Gb, bins, bins_b, xg, xg32, ys, yg, ysb, ygb, g_rid
    torch.cuda.empty_cache()

    comp_seconds = time.perf_counter() - comp_t0
    check(all(bf16_launches[k] > 0 for k in ("dia_spmv", "dia_spmm",
                                             "bsr_spmv", "bsr_spmm")),
          f"phase 12 bf16 launches {bf16_launches}")
    log({"phase": "main_path_compressed", "nvidia_smi": smi_line,
         "runs": comp_runs, "launches": phase12,
         "bf16_launches": bf16_launches, "kernel_vs_plain": comp_vs_plain,
         "widening_timing": widening, "sliced_ell": sliced,
         "obs": obs_check, "seconds": comp_seconds})

    csr_phases.close("12")

    # ---- 14. the distribution layer at world size 1 -------------------------
    from legate_sparse_tpu_torch.parallel.launch import run_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p14 = run_ranks(phase14_rank, 1, backend="nccl", timeout=900,
                    init_timeout=120, args=(gmg_ref,))[0]
    shutil.rmtree(ref_dir, ignore_errors=True)
    log({"phase": "main_path_distributed", "nvidia_smi": smi_line, **p14,
         "seconds": time.perf_counter() - t0})
    phase14 = p14["launches"]
    check(all(phase14[k] > 0 for k in ("dia_spmv", "dia_spmm", "bsr_spmv")),
          f"phase 14 launches {phase14}")

    csr_phases.close("14")

    # ---- 15. graph analytics and the delta layer ---------------------------
    torch.cuda.empty_cache()
    m_rec, m_launches = phase15_mutation()
    log({"phase": "main_path_mutation", "nvidia_smi": smi_line, **m_rec,
         "launches": m_launches})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p15 = run_ranks(phase15_rank, 1, backend="nccl", timeout=900,
                    init_timeout=120)[0]
    log({"phase": "main_path_graph", "nvidia_smi": smi_line, **p15,
         "seconds": time.perf_counter() - t0})
    phase15 = {k: m_launches[k] + p15["launches"][k] for k in m_launches}
    check(phase15["dia_spmv"] > 0, f"phase 15 launches {phase15}")

    csr_phases.close("15")

    # ---- 16. the serving path ----------------------------------------------
    torch.cuda.empty_cache()
    s_rec, s_timing, phase16 = phase16_serving()
    csr_held.extend(s_rec["csr_kernel_held"])
    log({"phase": "main_path_serving", "nvidia_smi": smi_line, **s_rec,
         "launches": phase16})
    log({"phase": "timing_serving", "nvidia_smi": smi_line, **s_timing})
    torch.cuda.empty_cache()

    csr_phases.close("16")

    # ---- 17. the resilience layer -------------------------------------------
    r_rec, r_launches = phase17_resilience()
    t0 = time.perf_counter()
    p17 = run_ranks(phase17_rank, 1, backend="nccl", timeout=900,
                    init_timeout=120)[0]
    phase17 = {k: r_launches[k] + p17["launches"][k] for k in r_launches}
    log({"phase": "main_path_resilience", "nvidia_smi": smi_line, **r_rec,
         "one_rank": p17, "one_rank_seconds": time.perf_counter() - t0,
         "launches": phase17})
    if torch.cuda.device_count() >= 2:
        ladder = run_ranks(phase17_ladder_rank, 2, backend="nccl",
                           timeout=600, init_timeout=120)
        check(ladder[1] == {"lost": True}, f"rank 1: {ladder[1]}")
        log({"phase": "recovery_ladder", "ranks": 2, **ladder[0]})
    else:
        log({"phase": "recovery_ladder", "skipped": "1 card"})
    check(phase17["dia_spmv"] > 0 and phase17["bsr_spmv"] > 0,
          f"phase 17 launches {phase17}")
    torch.cuda.empty_cache()

    csr_phases.close("17")

    # ---- 18. the operations layer -------------------------------------------
    o_rec, phase18 = phase18_operations()
    log({"phase": "main_path_operations", "nvidia_smi": smi_line, **o_rec,
         "launches": phase18})
    if torch.cuda.device_count() >= 2:
        world = min(torch.cuda.device_count(), 4)
        sub = run_ranks(phase18_submesh_rank, world, backend="nccl",
                        timeout=600, init_timeout=120)
        for r in sub:
            check(r["bitwise"] and r["member"] == (r["rank"] < 2)
                  and (r["collectives"] > 0) == (r["rank"] < 2),
                  f"placement submesh rank {r}")
        log({"phase": "placement_submesh", "ranks": world, "per_rank": sub})
    else:
        log({"phase": "placement_submesh", "skipped": "1 card"})
    torch.cuda.empty_cache()

    csr_phases.close("18")

    # ---- 19. the entry points ------------------------------------------------
    t0 = time.perf_counter()
    e_rec, phase19, entry_vs_plain = phase19_entry_points()
    log({"phase": "main_path_entry_points", "nvidia_smi": smi_line, **e_rec,
         "launches": phase19, "seconds_total": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    csr_phases.close("19")

    # ---- 20. the tools ---------------------------------------------------------
    t_rec, phase20, tools_vs_plain = phase20_tools(e_rec["bench"], smi_line)
    log({"phase": "main_path_tools", "nvidia_smi": smi_line, **t_rec,
         "launches": phase20, "kernel_vs_plain": tools_vs_plain})

    for row in (dia_row, bsr_row, dia_spmm_row, bsr_spmm_row,
                dia_spgemm_row):
        row["launches"] += (phase10[row["name"]] + phase11[row["name"]]
                            + phase12[row["name"]] + phase14[row["name"]]
                            + phase15[row["name"]] + phase16[row["name"]]
                            + phase17[row["name"]] + phase18[row["name"]]
                            + phase19[row["name"]] + phase20[row["name"]])
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            h["max_abs_err"] for h in (list(kernel_vs_plain.values())
                                       + list(spec_vs_plain.values())
                                       + list(comp_vs_plain.values())
                                       + list(p14["kernel_vs_plain"]
                                              .values())
                                       + list(entry_vs_plain.values())
                                       + list(tools_vs_plain.values()))
            if h["kernel"] == row["name"]])

    # The ELL SpMV ports no TPU kernel and is not among the wrappers
    # counted phase by phase: its rows take every launch of the kernel in
    # this process and in phase 14's rank (holds and timing loops too),
    # and the largest error of any check of it against the plain ops.
    ell_err = max([r["max_abs_err"] for r in ell_rows]
                  + [h["max_abs_err"] for h in ell_held]
                  + [h["max_abs_err"] for h in (
                      list(kernel_vs_plain.values())
                      + list(p14["kernel_vs_plain"].values()))
                     if h["kernel"] == "ell_spmv"])
    for row in ell_rows:
        row["launches"] = ell_kernel.ell_spmv.launches + p14["ell_launches"]
        row["max_abs_err"] = ell_err

    # The CSR SpMV ports no TPU kernel either: its row takes every launch
    # of the kernel in this process, each checked phase by phase against
    # the csr-rowids products that call for it, and the largest error of
    # its checks against the plain ops.
    csr_phases.close("20")
    check(sum(r["launches"] for r in csr_phases.phases)
          == csr_kernel.csr_spmv.launches,
          "the CSR kernel's launches escaped the phases' counts")
    check(all(sum(r["launches"] for r in csr_phases.phases
                  if r["phase"] == p) > 0 for p in ("8b", "9", "16")),
          f"a csr-rowids phase launched no CSR kernel: {csr_phases.phases}")
    log({"phase": "csr_kernel", "launches_by_phase": csr_phases.phases,
         "held": csr_held})
    csr_row["launches"] = csr_kernel.csr_spmv.launches
    csr_row["max_abs_err"] = max(h["max_abs_err"] for h in csr_held)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    log({"kernels": [{k: row[k] for k in keys}
                     for row in (dia_row, bsr_row, dia_spmm_row,
                                 bsr_spmm_row, dia_spgemm_row,
                                 *ell_rows, csr_row)]})
    print(smi_line, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
