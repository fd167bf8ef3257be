// Copyright 2026.
// SPDX-License-Identifier: Apache-2.0
//
// ELL SpMV for Hopper (sm_90a):
//   y[r] = sum over s < counts[r] of data[r, s] * x[cols[r, s]].
//
// Replaces no TPU kernel.  The JAX package's ELL product
// (legate_sparse_tpu/ops/spmv.py::ell_spmv) is XLA ops; the port ran it
// as plain PyTorch ops (ops/spmv.py::ell_spmv_plain), one pass over a
// whole (rows, W) block for each of the mask, the gather of x, the
// product, the masked select and the row sum.  This kernel makes one
// pass: each row's W values and columns and its count are read once,
// the x entries its stored slots name are read once, y is written once.
// It carries the V-cycle's restriction R and prolongation P (W 9 and 4
// at the fine level), which are too wide for BSR and not banded.
//
// Bound: bytes.  A slot is 2 operations against 8 to 16 bytes of value
// and column (f32 or f64, int32 or int64); the counts, x and y add 4 to
// 8 bytes a row each.  At the 8192² V-cycle's level 0 the pack is
// 1.61 GB for R (16,777,216 rows, W 9) and 2.75 GB for P (67,108,864
// rows, W 4); P's product itself needs 1.81 GB, since 44% of its slots
// are padding, which the kernel reads and a CSR product does not.
//
// The layout.  The pack is row-major (rows, W), so one thread a row
// reading slot by slot would stride W elements across a warp.  Instead a
// block of TILE_ROWS rows copies its contiguous TILE_ROWS x W tile of
// values and of columns into shared memory with coalesced loads
// (neighbouring threads, neighbouring elements; all W loads of a thread
// in flight at once), at an odd row stride (W | 1) so that the threads'
// reads of their own rows fall in distinct banks; then each thread loads
// the x entries of its row's stored slots (all in flight at once) and
// sums its row.  The kernel is compiled for W 1 to MAX_TILE_W (the
// V-cycle's R and P are 9 and 4 wide); ops/spmv.py::ell_spmv routes a
// wider pack, which no measured workload has, to the plain ops.
//
// Arithmetic: each product is rounded on its own (__fmul_rn, __dmul_rn)
// and added in slot order to a sum that starts at +0.0 (__fadd_rn,
// __dadd_rn): no FMA contraction.  A slot at or past counts[r] reads no
// x and adds nothing, which is adding +0.0 (the sum is never -0.0); so a
// non-finite x at a padded slot, which repeats the row's last column
// with value 0, never reaches y.  The plain version in slot order is
// ops/ell_kernel.py::ell_spmv_ordered; the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_ROWS 128  // rows (threads) of a block
#define MAX_TILE_W 16  // widest W the kernel is compiled for

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

// One thread a row, the row's slots staged in shared memory.
template <typename V, typename I, int W>
__global__ void __launch_bounds__(TILE_ROWS)
    ell_spmv_kernel(const V* __restrict__ data, const I* __restrict__ cols,
                    const int* __restrict__ counts, const V* __restrict__ x,
                    V* __restrict__ y, int64_t rows) {
  constexpr int SW = W | 1;
  __shared__ V sval[TILE_ROWS * SW];
  __shared__ I scol[TILE_ROWS * SW];
  const int64_t row0 = (int64_t)blockIdx.x * TILE_ROWS;
  const int nr = (int)min((int64_t)TILE_ROWS, rows - row0);
  const V* dtile = data + row0 * W;
  const I* ctile = cols + row0 * W;
  if (nr == TILE_ROWS) {
    V v[W];
    I c[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      v[k] = __ldcs(dtile + k * TILE_ROWS + threadIdx.x);
      c[k] = __ldcs(ctile + k * TILE_ROWS + threadIdx.x);
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int i = k * TILE_ROWS + threadIdx.x;
      const int r = i / W;
      sval[r * SW + (i - r * W)] = v[k];
      scol[r * SW + (i - r * W)] = c[k];
    }
  } else {
    for (int i = threadIdx.x; i < nr * W; i += TILE_ROWS) {
      const int r = i / W;
      sval[r * SW + (i - r * W)] = __ldcs(dtile + i);
      scol[r * SW + (i - r * W)] = __ldcs(ctile + i);
    }
  }
  __syncthreads();
  if ((int)threadIdx.x >= nr) return;
  const int64_t row = row0 + threadIdx.x;
  const int cnt = __ldcs(counts + row);
  const V* sv = sval + threadIdx.x * SW;
  const I* sc = scol + threadIdx.x * SW;
  V xv[W];
#pragma unroll
  for (int s = 0; s < W; ++s) xv[s] = s < cnt ? __ldg(x + sc[s]) : V(0);
  V acc = V(0);
#pragma unroll
  for (int s = 0; s < W; ++s)
    if (s < cnt) acc = add_rn(acc, mul_rn(sv[s], xv[s]));
  __stcs(y + row, acc);
}

template <typename V, typename I>
int launch(const void* data, const void* cols, const void* counts,
           const void* x, void* y, int64_t rows, int W, cudaStream_t s) {
  const V* d = (const V*)data;
  const I* c = (const I*)cols;
  const int* n = (const int*)counts;
  const V* xv = (const V*)x;
  V* yv = (V*)y;
  const int64_t blocks = (rows + TILE_ROWS - 1) / TILE_ROWS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  switch (W) {
#define ELL_W(w)                                                     \
  case w:                                                            \
    ell_spmv_kernel<V, I, w><<<grid, TILE_ROWS, 0, s>>>(d, c, n, xv, \
                                                        yv, rows);   \
    break;
    ELL_W(1) ELL_W(2) ELL_W(3) ELL_W(4) ELL_W(5) ELL_W(6) ELL_W(7) ELL_W(8)
    ELL_W(9) ELL_W(10) ELL_W(11) ELL_W(12) ELL_W(13) ELL_W(14) ELL_W(15)
    ELL_W(16)
#undef ELL_W
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// value_bytes 4 (f32) or 8 (f64), index_bytes 4 (int32) or 8 (int64),
// counts int32; 1 <= W <= MAX_TILE_W.  Returns the launch's cudaError
// (0 with no rows).
extern "C" int ell_spmv(const void* data, const void* cols,
                        const void* counts, const void* x, void* y,
                        int64_t rows, int W, int value_bytes,
                        int index_bytes, void* stream) {
  if (rows < 0 || W < 1 || W > MAX_TILE_W) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bytes == 4 && index_bytes == 4)
    return launch<float, int>(data, cols, counts, x, y, rows, W, s);
  if (value_bytes == 4 && index_bytes == 8)
    return launch<float, long long>(data, cols, counts, x, y, rows, W, s);
  if (value_bytes == 8 && index_bytes == 4)
    return launch<double, int>(data, cols, counts, x, y, rows, W, s);
  if (value_bytes == 8 && index_bytes == 8)
    return launch<double, long long>(data, cols, counts, x, y, rows, W, s);
  return (int)cudaErrorInvalidValue;
}
