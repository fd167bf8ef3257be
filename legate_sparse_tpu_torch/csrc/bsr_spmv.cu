// Copyright 2026.
// SPDX-License-Identifier: Apache-2.0
//
// Block-sparse (BSR) SpMV for Hopper (sm_90a).
//
// Replaces: legate_sparse_tpu/ops/bsr.py::bsr_spmv_pallas, the Pallas
// kernel behind csr_array.dot's irregular path.
//
// Bound: bytes.  Every present 128x128 block is read once in full
// (64 KiB in f32, 32 KiB in bf16) whatever its population, plus one
// 128-wide x chunk per block (from cache after its first read) and one
// f32 y row per block-row.  The 2*128*128 operations per block are far
// below the card's rate, so the floor is the blocks' bytes at 3.35 TB/s.
//
// Design: one CTA of 128 threads per block-row walks that row's blocks
// [bptr[br], bptr[br+1]) in order.  For each block it stages the x chunk
// x[bcol*128 : +128] in shared memory as f32, then thread r accumulates
// sum_c blkT[b, c, r] * xs[c] in f32.  The transposed block layout
// blkT[b, c, r] = A[R0 + r, C0 + c] makes the 32 threads of a warp read
// 32 consecutive values for each c: every load of the block is coalesced.
// Each output row is owned by one thread, so the kernel is deterministic
// and needs no atomics.  y is written in f32; the wrapper casts it to the
// matrix dtype, as BsrStructure.matvec does in the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BSR_B 128

static __device__ __forceinline__ float bsr_load(float v) { return v; }
static __device__ __forceinline__ float bsr_load(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(BSR_B)
    bsr_spmv_kernel(const T* __restrict__ blkT,
                    const int32_t* __restrict__ bcol,
                    const int64_t* __restrict__ bptr,
                    const T* __restrict__ x, float* __restrict__ y) {
  __shared__ float xs[BSR_B];
  const int64_t br = blockIdx.x;
  const int r = threadIdx.x;
  const int64_t b0 = bptr[br];
  const int64_t b1 = bptr[br + 1];
  float acc = 0.f;
  for (int64_t b = b0; b < b1; ++b) {
    const int64_t c0 = (int64_t)bcol[b] * BSR_B;
    __syncthreads();  // every thread is done with the previous chunk
    xs[r] = bsr_load(x[c0 + r]);
    __syncthreads();
    const T* blk = blkT + b * (int64_t)(BSR_B * BSR_B) + r;
#pragma unroll 16
    for (int c = 0; c < BSR_B; ++c) {
      acc = fmaf(bsr_load(blk[c * BSR_B]), xs[c], acc);
    }
  }
  y[br * BSR_B + r] = acc;
}

template <typename T>
static int bsr_spmv_launch(const void* blkT, const void* bcol,
                           const void* bptr, const void* x, void* y,
                           int64_t nbr, void* stream) {
  if (nbr < 0 || nbr > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (nbr == 0) return 0;
  bsr_spmv_kernel<T><<<(unsigned)nbr, BSR_B, 0, (cudaStream_t)stream>>>(
      (const T*)blkT, (const int32_t*)bcol, (const int64_t*)bptr,
      (const T*)x, (float*)y);
  return (int)cudaGetLastError();
}

extern "C" int bsr_spmv_f32(const void* blkT, const void* bcol,
                            const void* bptr, const void* x, void* y,
                            int64_t nbr, void* stream) {
  return bsr_spmv_launch<float>(blkT, bcol, bptr, x, y, nbr, stream);
}

extern "C" int bsr_spmv_bf16(const void* blkT, const void* bcol,
                             const void* bptr, const void* x, void* y,
                             int64_t nbr, void* stream) {
  return bsr_spmv_launch<__nv_bfloat16>(blkT, bcol, bptr, x, y, nbr, stream);
}
