// Copyright 2026.
// SPDX-License-Identifier: Apache-2.0
//
// CSR SpMV for Hopper (sm_90a):
//   y[r] = sum over offsets[r] <= j < offsets[r+1] of data[j] * x[cols[j]].
//
// Replaces no TPU kernel.  The JAX package's csr_spmv_rowids
// (legate_sparse_tpu/ops/spmv.py) is XLA's gather and segment_sum; the
// port ran it as plain PyTorch ops (ops/spmv.py::csr_spmv_rowids_plain):
// a widening copy of the columns to int64, a gather of x into an array
// of nnz entries, a product array of nnz entries, and a segmented
// reduction over the rows (CUB's, one thread block a row, for a matrix
// with a row past 1,024 entries).  This kernel makes one pass: each
// stored value and its column are read once, as they are stored, the x
// entry the column names is read once, and y is written once.  It
// builds no widened, gathered, product or row-id array.
//
// Bound: bytes, and the gathers of x.  A stored entry is 2 operations
// against 8 to 16 streamed bytes of value and column, plus a random read
// of x.  On a Graph500 graph at SCALE 25 the stream is 8.78 GB (values
// and int32 columns 4.19 GB each, int64 offsets 0.27 GB, x and y 0.13 GB
// each) and x is 134 MB against the 50 MB L2, so a gathered 4-byte value
// costs a 32-byte sector unless its column is a hot one.  The streams are
// read with evict-first loads (__ldcs) and x through the read-only path
// with an L2 evict-last policy, so that the streams do not push the hub
// columns' x sectors out of L2; on that graph the hints change the time
// by under 0.3%, and the misses of x take ~13 of a product's 18.5 ms
// (with every gather hitting, a product takes 5.3 ms).  Every thread
// starts all of its column loads, then all of its x loads, before it
// uses any, so that several gathers are in flight a thread.
//
// Load balance.  Row lengths run from 0 to ~10^6 on a power-law graph,
// half of the rows empty.  ops/csr_kernel.py::build_schedule makes, on
// the device and without a host sync, a schedule of two tables:
// - tiles: the rows whose first slot falls in one TILE-slot stretch of
//   the slots (at most TILE_ROWS rows a tile).  A tile block stages the
//   products of its rows' slots in shared memory with coalesced loads
//   (neighbouring threads, neighbouring slots), then sums each row in one
//   thread (csr_spmv_kernel).  A row of up to CHUNK slots that starts in
//   the stretch ends within CHUNK of it, so a block stages fewer than
//   TILE + CHUNK slots.
// - chunks: each row longer than CHUNK (a hub row) is cut into chunks of
//   CHUNK slots, one (row, first slot) entry a chunk.  One block a chunk
//   writes the chunk's sum to a partial (csr_spmv_hub_kernel), and a
//   second pass adds each hub row's partials in chunk order
//   (csr_spmv_hub_sum_kernel).  No float atomics.  A hub row starts a
//   tile's last row, and the tile block leaves it to the second pass.
// The chunk table is sized by an upper bound on the chunks (nnz / CHUNK
// + nnz / (CHUNK + 1)); its entries past the last chunk hold -1, and
// the chunk blocks walk it grid-stride, stopping at the first -1.
//
// Arithmetic, fixed and local to each row: each product is rounded on
// its own (__fmul_rn, __dmul_rn), and every sum starts at +0.0 and adds
// with __fadd_rn/__dadd_rn (no FMA contraction).
// - A row of at most CHUNK slots: its products in slot order.  So every
//   row of a matrix whose longest row is at most SERIAL_MAX_ROW
//   (ops/spmv.py, 1,024 = CHUNK) sums as the plain ops' one-thread-a-row
//   reduction does, bit for bit.
// - A hub row: chunk by chunk; in a chunk, thread t adds the products of
//   slots t, t + BLOCK, ... of the chunk in that order, the threads'
//   sums meet in a shuffle-down tree within each warp (offsets 16 to 1),
//   and the warps' in a shuffle-down tree in warp 0 (offsets 4 to 1);
//   the chunks' sums are added in chunk order.
// The order depends only on the row's own slots, never on where the row
// starts in memory or on any other row, so a padded or stacked copy of
// the matrix (the engine's packs) gives each row the same bits.
// ops/csr_kernel.py::csr_spmv_ordered is this arithmetic in plain
// PyTorch; the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

// The sizes below, timed on an H100 at a SCALE 25 Graph500 graph (18.5 ms
// a product): CHUNK 2,048 or 4,096, TILE 512 or 2,048 and BLOCK 128 or 512
// each came within 2% of them or slower; the gathers of x set the pace.
#define BLOCK 256        // threads of a tile block and of a chunk block
#define TILE 1024        // slots of the stretch a tile's rows start in
#define CHUNK 1024       // longest row a tile block sums; a hub row's chunk
#define TILE_ROWS 1024   // most rows in one tile
#define STAGE (TILE + CHUNK)  // slots a tile block stages, an upper bound

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// An L2 policy that keeps what it loads past the streamed lines.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// x through the read-only path under that policy.
__device__ __forceinline__ float load_x(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v)
      : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ double load_x(const double* p, uint64_t pol) {
  double v;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
      : "=d"(v)
      : "l"(p), "l"(pol));
  return v;
}

// One block a tile: the products of the tile's regular rows staged in
// shared memory, then one thread a row summing them in slot order.
template <typename V, typename I, typename O>
__global__ void __launch_bounds__(BLOCK)
    csr_spmv_kernel(const V* __restrict__ data, const I* __restrict__ cols,
                    const O* __restrict__ offsets, const V* __restrict__ x,
                    V* __restrict__ y, const int64_t* __restrict__ tile_rows) {
  constexpr int PER = STAGE / BLOCK;
  __shared__ V prod[STAGE];
  const int64_t r0 = tile_rows[blockIdx.x];
  const int64_t r1 = tile_rows[blockIdx.x + 1];
  if (r0 >= r1) return;
  const int64_t s0 = (int64_t)offsets[r0];
  const int64_t last = (int64_t)offsets[r1 - 1];
  int64_t s1 = (int64_t)offsets[r1];
  if (s1 - last > CHUNK) s1 = last;  // a hub row: the second pass's
  const int n = (int)(s1 - s0);
  const uint64_t pol = evict_last_policy();
  I c[PER];
  V v[PER];
  V xv[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * BLOCK;
    if (i < n) {
      c[k] = __ldcs(cols + s0 + i);
      v[k] = __ldcs(data + s0 + i);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if ((int)threadIdx.x + k * BLOCK < n) xv[k] = load_x(x + c[k], pol);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * BLOCK;
    if (i < n) prod[i] = mul_rn(v[k], xv[k]);
  }
  __syncthreads();
  for (int64_t r = r0 + threadIdx.x; r < r1; r += BLOCK) {
    const int64_t a = (int64_t)offsets[r];
    const int64_t b = (int64_t)offsets[r + 1];
    if (b - a > CHUNK) continue;
    V acc = V(0);
    const int lo = (int)(a - s0), hi = (int)(b - s0);
#pragma unroll 8
    for (int j = lo; j < hi; ++j) acc = add_rn(acc, prod[j]);
    __stcs(y + r, acc);
  }
}

// One block a chunk of a hub row, walking the chunk table grid-stride:
// the chunk's sum into partial[k].
template <typename V, typename I, typename O>
__global__ void __launch_bounds__(BLOCK)
    csr_spmv_hub_kernel(const V* __restrict__ data, const I* __restrict__ cols,
                        const O* __restrict__ offsets,
                        const V* __restrict__ x,
                        const int64_t* __restrict__ chunk_row,
                        const int64_t* __restrict__ chunk_start,
                        V* __restrict__ partial, int64_t bound) {
  constexpr int PER = CHUNK / BLOCK;
  constexpr int WARPS = BLOCK / 32;
  __shared__ V warp_sums[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint64_t pol = evict_last_policy();
  for (int64_t k = blockIdx.x; k < bound; k += gridDim.x) {
    const int64_t row = chunk_row[k];
    if (row < 0) return;  // past the last chunk, as every later entry
    const int64_t s = chunk_start[k];
    const int64_t e = min(s + CHUNK, (int64_t)offsets[row + 1]);
    I c[PER];
    V v[PER];
    V xv[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int64_t i = s + threadIdx.x + q * BLOCK;
      if (i < e) {
        c[q] = __ldcs(cols + i);
        v[q] = __ldcs(data + i);
      }
    }
#pragma unroll
    for (int q = 0; q < PER; ++q)
      if (s + threadIdx.x + q * BLOCK < e) xv[q] = load_x(x + c[q], pol);
    V acc = V(0);
#pragma unroll
    for (int q = 0; q < PER; ++q)
      if (s + threadIdx.x + q * BLOCK < e)
        acc = add_rn(acc, mul_rn(v[q], xv[q]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = add_rn(acc, __shfl_down_sync(0xffffffffu, acc, o));
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      V w = lane < WARPS ? warp_sums[lane] : V(0);
#pragma unroll
      for (int o = WARPS / 2; o > 0; o >>= 1)
        w = add_rn(w, __shfl_down_sync(0xffffffffu, w, o));
      if (lane == 0) partial[k] = w;
    }
    __syncthreads();
  }
}

// One thread a chunk entry, grid-stride: at a hub row's first chunk, the
// row's partials added in chunk order into y.
template <typename V, typename O>
__global__ void csr_spmv_hub_sum_kernel(const O* __restrict__ offsets,
                                        const int64_t* __restrict__ chunk_row,
                                        const int64_t* __restrict__ chunk_start,
                                        const V* __restrict__ partial,
                                        V* __restrict__ y, int64_t bound) {
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < bound;
       k += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = chunk_row[k];
    if (row < 0) return;
    const int64_t a = (int64_t)offsets[row];
    if (chunk_start[k] != a) continue;
    const int64_t n = ((int64_t)offsets[row + 1] - a + CHUNK - 1) / CHUNK;
    V acc = V(0);
    for (int64_t i = 0; i < n; ++i) acc = add_rn(acc, partial[k + i]);
    y[row] = acc;
  }
}

// Blocks of BLOCK threads that fill the card once, for a grid-stride
// kernel.
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK,
                                                    0) != cudaSuccess)
    return 0;
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename V, typename I, typename O>
int launch(const void* data, const void* cols, const void* offsets,
           const void* x, void* y, const void* tile_rows, int64_t tiles,
           const void* chunk_row, const void* chunk_start, void* partial,
           int64_t bound, cudaStream_t s) {
  const V* d = (const V*)data;
  const I* c = (const I*)cols;
  const O* o = (const O*)offsets;
  const V* xv = (const V*)x;
  V* yv = (V*)y;
  const int64_t* cr = (const int64_t*)chunk_row;
  const int64_t* cs = (const int64_t*)chunk_start;
  V* p = (V*)partial;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (bound > 0) {
    const int fill = resident_blocks(csr_spmv_hub_kernel<V, I, O>);
    if (fill <= 0) return (int)cudaErrorInvalidValue;
    const int64_t blocks = bound < fill ? bound : fill;
    csr_spmv_hub_kernel<V, I, O><<<(unsigned)blocks, BLOCK, 0, s>>>(
        d, c, o, xv, cr, cs, p, bound);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (tiles > 0) {
    csr_spmv_kernel<V, I, O><<<(unsigned)tiles, BLOCK, 0, s>>>(
        d, c, o, xv, yv, (const int64_t*)tile_rows);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (bound > 0) {
    const int64_t want = (bound + BLOCK - 1) / BLOCK;
    const int fill = resident_blocks(csr_spmv_hub_sum_kernel<V, O>);
    if (fill <= 0) return (int)cudaErrorInvalidValue;
    const int64_t blocks = want < fill ? want : fill;
    csr_spmv_hub_sum_kernel<V, O><<<(unsigned)blocks, BLOCK, 0, s>>>(
        o, cr, cs, p, yv, bound);
  }
  return (int)cudaGetLastError();
}

template <typename V, typename I>
int by_offsets(int offset_bytes, const void* data, const void* cols,
               const void* offsets, const void* x, void* y,
               const void* tile_rows, int64_t tiles, const void* chunk_row,
               const void* chunk_start, void* partial, int64_t bound,
               cudaStream_t s) {
  if (offset_bytes == 4)
    return launch<V, I, int>(data, cols, offsets, x, y, tile_rows, tiles,
                             chunk_row, chunk_start, partial, bound, s);
  if (offset_bytes == 8)
    return launch<V, I, long long>(data, cols, offsets, x, y, tile_rows,
                                   tiles, chunk_row, chunk_start, partial,
                                   bound, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// value_bytes 4 (f32) or 8 (f64), index_bytes and offset_bytes 4 (int32)
// or 8 (int64).  tile_rows holds tiles + 1 int64 row bounds; chunk_row
// and chunk_start hold bound int64 entries (-1 past the last chunk);
// partial holds bound values.  Returns the first launch's cudaError that
// is not 0, else 0.
extern "C" int csr_spmv(const void* data, const void* cols,
                        const void* offsets, const void* x, void* y,
                        const void* tile_rows, int64_t tiles,
                        const void* chunk_row, const void* chunk_start,
                        void* partial, int64_t bound, int value_bytes,
                        int index_bytes, int offset_bytes, void* stream) {
  if (tiles < 0 || bound < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bytes == 4 && index_bytes == 4)
    return by_offsets<float, int>(offset_bytes, data, cols, offsets, x, y,
                                  tile_rows, tiles, chunk_row, chunk_start,
                                  partial, bound, s);
  if (value_bytes == 4 && index_bytes == 8)
    return by_offsets<float, long long>(offset_bytes, data, cols, offsets, x,
                                        y, tile_rows, tiles, chunk_row,
                                        chunk_start, partial, bound, s);
  if (value_bytes == 8 && index_bytes == 4)
    return by_offsets<double, int>(offset_bytes, data, cols, offsets, x, y,
                                   tile_rows, tiles, chunk_row, chunk_start,
                                   partial, bound, s);
  if (value_bytes == 8 && index_bytes == 8)
    return by_offsets<double, long long>(offset_bytes, data, cols, offsets, x,
                                         y, tile_rows, tiles, chunk_row,
                                         chunk_start, partial, bound, s);
  return (int)cudaErrorInvalidValue;
}
