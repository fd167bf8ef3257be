// Copyright 2026.
// SPDX-License-Identifier: Apache-2.0
//
// Banded SpGEMM for Hopper (sm_90a): C_dia = A_dia @ B_dia.
//
// Replaces: legate_sparse_tpu/ops/pallas_dia.py::pallas_dia_spgemm, the
// Pallas kernel behind csr_array.dot's banded sparse-sparse path.
//
// Layout: scipy's column-aligned DIA, in and out.  a[a_i, t] = A[t - oa, t]
// (width k), b[b_i, j] = B[j - ob, j] and c[c_i, j] = C[j - oc, j] (width n),
// so C[oc, j] += A[oa, j - ob] * B[ob, j] with oc = oa + ob, valid on
// [max(0, ob, oc), min(n, k + ob, m + oc)).  Exact bands only: every
// in-bounds slot is an entry, so there is no mask.
//
// Bound: bytes.  Each of A's and B's band values read once from device
// memory and each of C's written once: 4 B * 2^24 * (5 + 5 + 9) =
// 1,275,068,416 B, 0.3806 ms at 3.35 TB/s, for the 5-diagonal band
// squared at 2^24 columns.  Two operations per (pair, column) are far
// below the card's rate.
//
// The first port gave each output diagonal its own CTAs and read
// a[a_i, j - ob] and b[b_i, j] from device memory for every pair: 25
// pairs at the chip shape, so it moved 3,959,422,976 B, 3.1x the bound,
// and L2 could not catch the re-reads (the CTAs of the 9 output diagonals
// sweep 64 MB band rows at different times against a 50 MB L2).
//
// Tiled variant (the design): a CTA of 256 threads owns TILE = 1024
// consecutive columns [j0, j0 + TILE) and computes every output diagonal
// there.  It stages A's diagonals over the tile's reach
// [j0 - max ob, j0 + TILE - min ob) and B's over the tile in shared
// memory with 16-byte cp.async copies (each staged row starts at the
// 16-byte boundary at or below its first element; only a chunk that
// leaves the row, at the matrix's edges, is copied element by element
// and zero-filled).  So every band value is read from device memory once,
// plus a halo of max ob - min ob columns per tile, and each C value is
// written once.  Thread t owns the columns j0 + t + 256 v, v < 4: the
// lanes of a warp read consecutive shared words whatever the shift, so
// no read has a bank conflict, and each warp's C store is one coalesced
// line, 4 bytes (f32) or 2 (bf16) a lane.  16-byte C stores would need
// a thread to own 4 consecutive columns, and then the shifted A reads
// conflict 4-way; passing each warp's values through shared memory to
// store 16 bytes a lane measured no faster in f32 and 8% slower in
// bf16 on an H100, so the kernel stores from the accumulators.
// The pair table is staged per CTA as 32-bit (A offset, B offset,
// lo - j0, hi - j0) records, so the tile's index arithmetic is 32-bit.
// A pair whose range covers the tile takes a branch-free loop, one that
// misses it is skipped, and only a pair that starts or ends inside the
// tile (the first and last tiles) tests each column.
//
// General variant: one CTA row per output diagonal (blockIdx.y = c_i)
// and a grid-stride loop over j, reading both operands from device
// memory for every pair.  It takes every shape the tiled variant cannot:
// A's staged reach too wide for shared memory (offsets past +-2^17), too
// many diagonals (nda = ndb = 33 in f32), or n at 2^30 and above.  The
// wrapper chooses (ops/dia_kernel.py::spgemm_tiled_ok) and this file
// checks the choice again.
//
// The pair table, for each output diagonal the (a_i, b_i, ob, j_lo, j_hi)
// of every pair that reaches it in offs_b order (the order of the Pallas
// kernel's outer loop over B's diagonals), is built once per product
// shape and cached on the card by the wrapper: a call makes no host to
// device copy.  Both variants add each output slot's pairs in that
// order: the product rounded to the storage type (F32/BF16 of
// dia_common.cuh), the sum in f32 with __fadd_rn from 0, the result
// rounded to the storage type.  That is the arithmetic of the plain
// PyTorch version (ops/dia_kernel.py::dia_spgemm_plain), so the two agree
// bit for bit.  C has the inputs' dtype.

#include <cuda_pipeline.h>

#include "dia_common.cuh"

#define SPGEMM_THREADS 256
#define SPGEMM_V 4                                // columns a thread owns
#define SPGEMM_TILE (SPGEMM_THREADS * SPGEMM_V)  // columns a CTA owns
#define SPGEMM_SMEM_MAX 232448                    // 227 KB a CTA
#define SPGEMM_MAX_COLS (1 << 30)                 // tiled: n, k below it

// One pair as the tiled variant stages it: where the pair's A and B
// values for the tile's column 0 sit in shared memory, and its valid
// range relative to the tile's first column.
struct __align__(16) TilePair {
  int a, b, lo, hi;
};

// Elements from the 16-byte boundary at or below &row[g] to &row[g].
template <class Tr>
__device__ __forceinline__ int lead_of(const typename Tr::Raw* row,
                                       int64_t g) {
  const uintptr_t addr =
      (uintptr_t)row + (uintptr_t)(g * (int64_t)sizeof(typename Tr::Raw));
  return (int)((addr & 15u) / sizeof(typename Tr::Raw));
}

// Shared row widths, in elements: the lead (< V16) plus what the tile
// reads, rounded up to whole 16-byte chunks.
template <class Tr>
__host__ __device__ inline int64_t tiled_wa(int span) {
  return ((int64_t)SPGEMM_TILE + span + 2 * Tr::V16 - 2) / Tr::V16 *
         Tr::V16;
}
template <class Tr>
__host__ __device__ inline int64_t tiled_wb() {
  return SPGEMM_TILE + Tr::V16;
}

template <class Tr>
static int64_t tiled_smem(int nda, int ndb, int ndc, int npairs, int span) {
  return (int64_t)sizeof(typename Tr::Raw) *
             (nda * tiled_wa<Tr>(span) + ndb * tiled_wb<Tr>()) +
         (int64_t)sizeof(TilePair) * npairs + 4 * (int64_t)(ndc + 1);
}

// Copies row[g0 - lead, g0 + w), rounded up to whole 16-byte chunks,
// into srow, where lead (< V16) puts the first chunk at a 16-byte
// boundary; slots outside the row [0, len) are zero-filled.
template <class Tr>
__device__ __forceinline__ void stage_row(typename Tr::Raw* srow,
                                          const typename Tr::Raw* row,
                                          int len, int g0, int w) {
  constexpr int V16 = Tr::V16;
  const int first = g0 - lead_of<Tr>(row, g0);
  const int chunks = (g0 - first + w + V16 - 1) / V16;
  for (int q = threadIdx.x; q < chunks; q += SPGEMM_THREADS) {
    const int g = first + q * V16;
    typename Tr::Raw* dst = srow + q * V16;
    if (g >= 0 && g <= len - V16) {
      __pipeline_memcpy_async(dst, row + g, 16);
    } else {
#pragma unroll
      for (int e = 0; e < V16; ++e) {
        const int ge = g + e;
        dst[e] = (ge >= 0 && ge < len) ? row[ge] : (typename Tr::Raw)0;
      }
    }
  }
}

template <class Tr>
__global__ void __launch_bounds__(SPGEMM_THREADS)
    dia_spgemm_tiled(const typename Tr::Raw* __restrict__ a,
                     const typename Tr::Raw* __restrict__ b,
                     typename Tr::Raw* __restrict__ c, int k, int n,
                     int nda, int ndb, int ndc, int npairs, int max_ob,
                     int span, const int64_t* __restrict__ pairs,
                     const int64_t* __restrict__ pair_ptr) {
  using Raw = typename Tr::Raw;
  constexpr int T = SPGEMM_TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wa = (int)tiled_wa<Tr>(span);
  const int wb = (int)tiled_wb<Tr>();
  Raw* sa = reinterpret_cast<Raw*>(smem);
  Raw* sb = sa + nda * wa;
  TilePair* sp = reinterpret_cast<TilePair*>(sb + ndb * wb);
  int* sptr = reinterpret_cast<int*>(sp + npairs);
  const int j0 = blockIdx.x * T;
  const int ga = j0 - max_ob;  // A's first column in the tile's reach

  for (int r = 0; r < nda; ++r)
    stage_row<Tr>(sa + r * wa, a + (int64_t)r * k, k, ga, T + span);
  for (int r = 0; r < ndb; ++r)
    stage_row<Tr>(sb + r * wb, b + (int64_t)r * n, n, j0, T);
  __pipeline_commit();
  for (int p = threadIdx.x; p < npairs; p += SPGEMM_THREADS) {
    const int64_t* q = pairs + 5 * p;
    const int ai = (int)q[0], bi = (int)q[1], ob = (int)q[2];
    sp[p] = {ai * wa + lead_of<Tr>(a + (int64_t)ai * k, ga) + (max_ob - ob),
             bi * wb + lead_of<Tr>(b + (int64_t)bi * n, j0),
             (int)(q[3] - j0), (int)(q[4] - j0)};
  }
  for (int ci = threadIdx.x; ci <= ndc; ci += SPGEMM_THREADS)
    sptr[ci] = (int)pair_ptr[ci];
  __pipeline_wait_prior(0);
  __syncthreads();

  const int t = threadIdx.x;
  for (int ci = 0; ci < ndc; ++ci) {
    float acc[SPGEMM_V];
#pragma unroll
    for (int v = 0; v < SPGEMM_V; ++v) acc[v] = 0.f;
    const int p1 = sptr[ci + 1];
    for (int p = sptr[ci]; p < p1; ++p) {
      const TilePair q = sp[p];
      if (q.hi <= 0 || q.lo >= T) continue;  // the pair misses the tile
      const Raw* ap = sa + q.a + t;
      const Raw* bp = sb + q.b + t;
      if (q.lo <= 0 && q.hi >= T) {
#pragma unroll
        for (int v = 0; v < SPGEMM_V; ++v)
          acc[v] = __fadd_rn(acc[v],
                             Tr::product(Tr::val(ap[v * SPGEMM_THREADS]),
                                         Tr::val(bp[v * SPGEMM_THREADS])));
      } else {
#pragma unroll
        for (int v = 0; v < SPGEMM_V; ++v) {
          const int jl = t + v * SPGEMM_THREADS;
          if (jl >= q.lo && jl < q.hi)
            acc[v] = __fadd_rn(acc[v],
                               Tr::product(Tr::val(ap[v * SPGEMM_THREADS]),
                                           Tr::val(bp[v * SPGEMM_THREADS])));
        }
      }
    }
    Raw* crow = c + (int64_t)ci * n + j0 + t;
    const int rest = n - j0 - t;  // columns of this row left from j0 + t
#pragma unroll
    for (int v = 0; v < SPGEMM_V; ++v)
      if (v * SPGEMM_THREADS < rest)
        __stcs(crow + v * SPGEMM_THREADS, Tr::raw(acc[v]));
  }
}

// pairs: (npairs, 5) int64 rows (a_i, b_i, ob, j_lo, j_hi);
// pair_ptr: (ndc + 1,) int64, the pairs of output diagonal c_i are
// [pair_ptr[c_i], pair_ptr[c_i + 1]).
template <class Tr>
__global__ void __launch_bounds__(256)
    dia_spgemm_general(const typename Tr::Raw* __restrict__ a,
                       const typename Tr::Raw* __restrict__ b,
                       typename Tr::Raw* __restrict__ c, int64_t k,
                       int64_t n, const int64_t* __restrict__ pairs,
                       const int64_t* __restrict__ pair_ptr) {
  const int64_t ci = blockIdx.y;
  const int64_t p0 = pair_ptr[ci];
  const int64_t p1 = pair_ptr[ci + 1];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    float acc = 0.f;
    for (int64_t p = p0; p < p1; ++p) {
      const int64_t* q = pairs + 5 * p;
      if (j >= q[3] && j < q[4]) {
        acc = __fadd_rn(acc, Tr::product(Tr::val(a[q[0] * k + (j - q[2])]),
                                         Tr::val(b[q[1] * n + j])));
      }
    }
    __stcs(c + ci * n + j, Tr::raw(acc));
  }
}

template <class Tr>
static int dia_spgemm_launch(const void* a, const void* b, void* c,
                             int64_t k, int64_t n, int64_t nda, int64_t ndb,
                             int64_t ndc, int64_t npairs, int64_t max_ob,
                             int64_t span, const void* pairs,
                             const void* pair_ptr, int tiled, void* stream) {
  using Raw = typename Tr::Raw;
  if (k < 0 || n < 0 || nda < 0 || ndb < 0 || ndc < 0 || ndc > 65535 ||
      npairs < 0 || span < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || ndc == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiled) {
    // The wrapper's choice (ops/dia_kernel.py::spgemm_tiled_ok), checked.
    if (n >= SPGEMM_MAX_COLS || k >= SPGEMM_MAX_COLS ||
        max_ob <= -SPGEMM_MAX_COLS || max_ob >= SPGEMM_MAX_COLS ||
        span >= SPGEMM_MAX_COLS || nda > DIA_MAX_DIAGS ||
        ndb > DIA_MAX_DIAGS || npairs > nda * ndb)
      return (int)cudaErrorInvalidValue;
    const int64_t smem = tiled_smem<Tr>((int)nda, (int)ndb, (int)ndc,
                                        (int)npairs, (int)span);
    if (smem > SPGEMM_SMEM_MAX) return (int)cudaErrorInvalidValue;
    // Above 48 KB a CTA needs the opt-in, once per device.
    static bool attr_set[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!attr_set[dev]) {
      e = cudaFuncSetAttribute(dia_spgemm_tiled<Tr>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SPGEMM_SMEM_MAX);
      if (e != cudaSuccess) return (int)e;
      attr_set[dev] = true;
    }
    const unsigned tiles = (unsigned)((n + SPGEMM_TILE - 1) / SPGEMM_TILE);
    dia_spgemm_tiled<Tr><<<tiles, SPGEMM_THREADS, (size_t)smem, s>>>(
        (const Raw*)a, (const Raw*)b, (Raw*)c, (int)k, (int)n, (int)nda,
        (int)ndb, (int)ndc, (int)npairs, (int)max_ob, (int)span,
        (const int64_t*)pairs, (const int64_t*)pair_ptr);
  } else {
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    // With blockIdx.y over the output diagonals, cap the x extent so the
    // whole grid stays a few waves deep; the grid-stride loop takes the
    // rest.
    int64_t cap = (132 * 64 + ndc - 1) / ndc;
    if (cap < 1) cap = 1;
    if (blocks > cap) blocks = cap;
    dim3 grid((unsigned)blocks, (unsigned)ndc);
    dia_spgemm_general<Tr><<<grid, threads, 0, s>>>(
        (const Raw*)a, (const Raw*)b, (Raw*)c, k, n, (const int64_t*)pairs,
        (const int64_t*)pair_ptr);
  }
  return (int)cudaGetLastError();
}

#define DIA_SPGEMM_ENTRY(NAME, TR)                                          \
  extern "C" int NAME(const void* a, const void* b, void* c, int64_t k,     \
                      int64_t n, int64_t nda, int64_t ndb, int64_t ndc,     \
                      int64_t npairs, int64_t max_ob, int64_t span,         \
                      const void* pairs, const void* pair_ptr, int tiled,   \
                      void* stream) {                                       \
    return dia_spgemm_launch<TR>(a, b, c, k, n, nda, ndb, ndc, npairs,      \
                                 max_ob, span, pairs, pair_ptr, tiled,      \
                                 stream);                                   \
  }

DIA_SPGEMM_ENTRY(dia_spgemm_f32, F32)
DIA_SPGEMM_ENTRY(dia_spgemm_bf16, BF16)
