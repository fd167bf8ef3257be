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
// Bound: bytes.  Each of A's and B's band values is read once from device
// memory (the re-reads of A's diagonals for the other B offsets come
// from cache) and each of C's written once: 4 B * 2^24 * (5 + 5 + 9) =
// 1.28 GB, ~0.38 ms at 3.35 TB/s, for the 5-diagonal band squared at 2^24
// columns.  Two operations per (pair, column) are far below the card's
// rate.
//
// Design: one thread per output slot (c_i, j), with j consecutive across
// the threads of a block (blockIdx.y = c_i, a grid-stride loop over j),
// so every load of a[a_i, j - ob] and b[b_i, j] and every store of
// c[c_i, j] is coalesced.  The host lists, for each output diagonal, the
// (a_i, b_i, ob, j_lo, j_hi) of every pair that reaches it, in ascending
// ob: the order of the Pallas kernel's outer loop over B's diagonals.
// For each ob there is at most one oa = oc - ob.  The thread adds the
// pairs whose range holds j in that order: the product rounded to the
// storage type (f32: __fmul_rn; bf16: one rounding of the exact product),
// the sum in f32 with __fadd_rn.  That is the arithmetic of the plain
// PyTorch version (ops/dia_kernel.py::dia_spgemm_plain), so the two agree
// bit for bit.  C has the inputs' dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
struct DiaIo;

template <>
struct DiaIo<float> {
  static __device__ __forceinline__ float product(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float out(float acc) { return acc; }
};

template <>
struct DiaIo<__nv_bfloat16> {
  static __device__ __forceinline__ float product(__nv_bfloat16 a,
                                                  __nv_bfloat16 b) {
    // The exact product of two bf16 values fits in f32; rounding it to
    // bf16 once is the storage-type product the plain version takes.
    return __bfloat162float(__float2bfloat16(
        __fmul_rn(__bfloat162float(a), __bfloat162float(b))));
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float acc) {
    return __float2bfloat16(acc);
  }
};

// pairs: (npairs, 5) int64 rows (a_i, b_i, ob, j_lo, j_hi);
// pair_ptr: (ndc + 1,) int64, the pairs of output diagonal c_i are
// [pair_ptr[c_i], pair_ptr[c_i + 1]).
template <typename T>
__global__ void __launch_bounds__(256)
    dia_spgemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ c, int64_t k, int64_t n,
                      const int64_t* __restrict__ pairs,
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
        acc = __fadd_rn(acc, DiaIo<T>::product(a[q[0] * k + (j - q[2])],
                                               b[q[1] * n + j]));
      }
    }
    c[ci * n + j] = DiaIo<T>::out(acc);
  }
}

template <typename T>
static int dia_spgemm_launch(const void* a, const void* b, void* c,
                             int64_t k, int64_t n, int64_t ndc,
                             const void* pairs, const void* pair_ptr,
                             void* stream) {
  if (k < 0 || n < 0 || ndc < 0 || ndc > 65535)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || ndc == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // With blockIdx.y over the output diagonals, cap the x extent so the
  // whole grid stays a few waves deep; the grid-stride loop takes the rest.
  int64_t cap = (132 * 64 + ndc - 1) / ndc;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  dim3 grid((unsigned)blocks, (unsigned)ndc);
  dia_spgemm_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (T*)c, k, n, (const int64_t*)pairs,
      (const int64_t*)pair_ptr);
  return (int)cudaGetLastError();
}

extern "C" int dia_spgemm_f32(const void* a, const void* b, void* c,
                              int64_t k, int64_t n, int64_t ndc,
                              const void* pairs, const void* pair_ptr,
                              void* stream) {
  return dia_spgemm_launch<float>(a, b, c, k, n, ndc, pairs, pair_ptr,
                                  stream);
}

extern "C" int dia_spgemm_bf16(const void* a, const void* b, void* c,
                               int64_t k, int64_t n, int64_t ndc,
                               const void* pairs, const void* pair_ptr,
                               void* stream) {
  return dia_spgemm_launch<__nv_bfloat16>(a, b, c, k, n, ndc, pairs,
                                          pair_ptr, stream);
}
