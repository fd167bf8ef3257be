// Copyright 2026.
// SPDX-License-Identifier: Apache-2.0
//
// Block-sparse (BSR) SpMM for Hopper (sm_90a): Y = A @ X for a dense X.
//
// Replaces: legate_sparse_tpu/ops/bsr.py::bsr_spmm_pallas, the Pallas
// kernel behind BsrStructure.matmat (csr_array.dot's irregular path for
// a matrix operand).
//
// Bound: bytes at small k.  Every present 128x128 block is read in full
// (64 KiB in f32, 32 KiB in bf16) whatever its population; X and Y are
// (cols, k) and (rows, k) row-major.  At 65,536 f32 blocks and k = 16 the
// blocks alone are 4.3 GB, ~1.3 ms at 3.35 TB/s, against ~0.5 ms for the
// 2*128*128*k operations per block at 67 TFLOP/s f32.
//
// Design: one CTA of 256 threads per (block-row, 32-column tile of X).
// It walks the block-row's blocks [bptr[br], bptr[br+1]) in bcol order.
// For each block it stages the block (as f32, 64 KiB) and the
// 128 x 32 chunk of X under it (16 KiB) in dynamic shared memory, then
// each thread accumulates a 4-row x 4-column piece of the 128 x 32 output
// tile in f32 registers with plain fmaf (no tensor cores, no TF32): rows
// r0 + 32q of a warp are consecutive (the transposed block layout
// blkT[b, c, r] = A[R0 + r, C0 + c] makes every shared read of the block
// conflict-free) and its 4 columns are the same for the whole warp (a
// broadcast).  Every output element is owned by one thread and summed in
// a fixed order (blocks in bcol order, c ascending inside a block), so
// the kernel is deterministic and needs no atomics.  80 KiB of shared
// memory is above the 48 KiB default, so the launch raises the limit with
// cudaFuncSetAttribute.  The block is re-read once per 32-column tile;
// at k <= 32 that is once.  Y is written in f32; the wrapper casts it to
// the matrix dtype, as BsrStructure.matmat does in the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BSR_B 128
#define BSR_KT 32
#define BSR_THREADS 256
#define BSR_SMEM_BYTES ((BSR_B * BSR_B + BSR_B * BSR_KT) * (int)sizeof(float))

static __device__ __forceinline__ float bsr_load(float v) { return v; }
static __device__ __forceinline__ float bsr_load(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(BSR_THREADS)
    bsr_spmm_kernel(const T* __restrict__ blkT,
                    const int32_t* __restrict__ bcol,
                    const int64_t* __restrict__ bptr,
                    const T* __restrict__ X, float* __restrict__ Y,
                    int64_t k) {
  extern __shared__ float smem[];
  float* As = smem;                  // [c][r], 128 x 128
  float* Xs = smem + BSR_B * BSR_B;  // [c][kc], 128 x 32
  const int64_t br = blockIdx.x;
  const int64_t k0 = (int64_t)blockIdx.y * BSR_KT;
  const int t = threadIdx.x;
  const int r0 = t & 31;
  const int c0 = (t >> 5) * 4;
  const int64_t b0 = bptr[br];
  const int64_t b1 = bptr[br + 1];
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[q][p] = 0.f;

  for (int64_t b = b0; b < b1; ++b) {
    __syncthreads();  // every thread is done with the previous block
    const T* blk = blkT + b * (int64_t)(BSR_B * BSR_B);
    for (int i = t; i < BSR_B * BSR_B; i += BSR_THREADS)
      As[i] = bsr_load(blk[i]);
    const int64_t xrow0 = (int64_t)bcol[b] * BSR_B;
    for (int i = t; i < BSR_B * BSR_KT; i += BSR_THREADS) {
      const int c = i / BSR_KT;
      const int64_t col = k0 + (i - c * BSR_KT);
      Xs[i] = col < k ? bsr_load(X[(xrow0 + c) * k + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BSR_B; ++c) {
      float a[4], x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = As[c * BSR_B + r0 + 32 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p) x[p] = Xs[c * BSR_KT + c0 + p];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(a[q], x[p], acc[q][p]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t row = br * BSR_B + r0 + 32 * q;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int64_t col = k0 + c0 + p;
      if (col < k) Y[row * k + col] = acc[q][p];
    }
  }
}

template <typename T>
static int bsr_spmm_launch(const void* blkT, const void* bcol,
                           const void* bptr, const void* X, void* Y,
                           int64_t nbr, int64_t k, void* stream) {
  if (nbr < 0 || nbr > 0x7fffffffLL || k < 1) return (int)cudaErrorInvalidValue;
  const int64_t ktiles = (k + BSR_KT - 1) / BSR_KT;
  if (ktiles > 65535) return (int)cudaErrorInvalidValue;
  if (nbr == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BSR_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nbr, (unsigned)ktiles);
  bsr_spmm_kernel<T><<<grid, BSR_THREADS, BSR_SMEM_BYTES,
                       (cudaStream_t)stream>>>(
      (const T*)blkT, (const int32_t*)bcol, (const int64_t*)bptr,
      (const T*)X, (float*)Y, k);
  return (int)cudaGetLastError();
}

extern "C" int bsr_spmm_f32(const void* blkT, const void* bcol,
                            const void* bptr, const void* X, void* Y,
                            int64_t nbr, int64_t k, void* stream) {
  return bsr_spmm_launch<float>(blkT, bcol, bptr, X, Y, nbr, k, stream);
}

extern "C" int bsr_spmm_bf16(const void* blkT, const void* bcol,
                             const void* bptr, const void* X, void* Y,
                             int64_t nbr, int64_t k, void* stream) {
  return bsr_spmm_launch<__nv_bfloat16>(blkT, bcol, bptr, X, Y, nbr, k,
                                        stream);
}
