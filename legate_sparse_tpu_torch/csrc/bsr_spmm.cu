// Copyright 2026.
// SPDX-License-Identifier: Apache-2.0
//
// Block-sparse (BSR) SpMM for Hopper (sm_90a): Y = A @ X for a dense,
// row-major X over the present 128x128 blocks of a CSR matrix, reading
// only its stored nonzeros.
//
// Replaces: legate_sparse_tpu/ops/bsr.py::bsr_spmm_pallas, the Pallas
// kernel behind BsrStructure.matmat (csr_array.dot's irregular path for a
// matrix operand).  It keeps that kernel's function, including the rule
// that the zero slots of a present block multiply X, and drops its dense
// block storage, which the TPU needed for the MXU.
//
// Bound: bytes at small k.  Each input read once: the CSR values and
// column indices (8 B per nonzero in f32 with int32 indices), indptr
// (int64), bcol, bptr, X and Y (rows x k, f32).  At 2^20 rows, 16
// nonzeros per row, 65,536 blocks and k = 16 that is 277,151,760 B,
// 0.08273 ms at 3.35 TB/s, against 2 * 16 flops per nonzero (8.1 us at
// 67 TFLOP/s f32).  The X chunks that the present blocks stage (537 MB at
// that shape) come from L2 or, since X (67 MB) is larger than the 50 MB
// L2, partly from device memory again.  Tensor cores do not apply: without
// dense tiles there is no matrix product to hand them.
//
// Design: one CTA of 256 threads per (block-row, KT-column tile of X),
// KT = 16 for k <= 16, else 32.  Lanes map to columns of X: a group of
// KT lanes (a half-warp or a warp) owns one row at a time and the
// 256 / KT groups stride over the block-row's 128 rows.  All lanes of a
// group read the same (value, column) entry, a broadcast, and each lane
// does acc = fmaf(v, Xs[c][lane], acc): shared reads are conflict-free and
// writes of Y coalesced.  For each group of G present blocks (G * 128 * KT
// values, 16 KiB) the 128 x KT chunks of X under them are staged in shared
// memory with cp.async into two buffers, so the next group loads while
// this one computes; a tile that is ragged (k0 + KT > k) or whose rows are
// not 16-byte multiples is staged by plain loads, zero past k.  Each
// chunk holding a non-finite value is marked; there the row walks all 128
// columns in order with fmaf(stored ? v : 0, Xs[c][lane], acc), as the
// dense kernel did, so 0 * inf gives NaN exactly where the Pallas kernel
// gives it; elsewhere the zero slots are skipped, which changes nothing
// for finite X (up to the sign of a zero).  Every output element is owned
// by one lane and summed in a fixed order (blocks in bcol order, columns
// ascending): deterministic, no atomics.  Y is written in f32; the
// wrapper casts it to the matrix dtype.  Templated on the value type
// (f32, bf16) and the column index type (int16 for compressed storage,
// int32, int64).
//
// Known limits: little else is in flight while a CTA waits for a group of
// X chunks (ptxas gives some instances about 123 registers, so two CTAs
// share an SM; a register cap spilled and ran slower); a block-row with
// one much longer row holds its CTA until that row is done.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BSR_B 128
#define BSR_THREADS 256
#define BSR_STAGE_BYTES 16384

static __device__ __forceinline__ float bsr_load(float v) { return v; }
static __device__ __forceinline__ float bsr_load(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
static __device__ __forceinline__ T bsr_zero();
template <>
__device__ __forceinline__ float bsr_zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 bsr_zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T, typename I, int KT>
__global__ void __launch_bounds__(BSR_THREADS)
    bsr_spmm_kernel(const T* __restrict__ data, const I* __restrict__ indices,
                    const int64_t* __restrict__ indptr,
                    const int32_t* __restrict__ bcol,
                    const int64_t* __restrict__ bptr,
                    const T* __restrict__ X, float* __restrict__ Y,
                    int64_t rows, int64_t k) {
  constexpr int CHUNK = BSR_B * KT;                    // values per chunk
  constexpr int G = BSR_STAGE_BYTES / (CHUNK * (int)sizeof(T)) > 0
                        ? BSR_STAGE_BYTES / (CHUNK * (int)sizeof(T))
                        : 1;                           // chunks per group
  constexpr int PIECE = 16 / sizeof(T);                // values per copy
  constexpr int NGRP = BSR_THREADS / KT;               // row groups
  constexpr int RPG = BSR_B / NGRP;                    // rows per group
  __shared__ __align__(16) unsigned char xs_raw[2 * G * CHUNK * sizeof(T)];
  T* xs = reinterpret_cast<T*>(xs_raw);                // [2][G][128][KT]
  __shared__ int32_t sbcol[2][G];
  __shared__ int32_t sflag[2][G];
  __shared__ int64_t sp0[BSR_B], spe[BSR_B];
  const int64_t br = blockIdx.x;
  const int64_t k0 = (int64_t)blockIdx.y * KT;
  const int t = threadIdx.x;
  const int grp = t / KT;
  const int lane = t % KT;
  const int64_t b0 = bptr[br];
  const int nblk = (int)(bptr[br + 1] - b0);
  const int nstage = (nblk + G - 1) / G;
  // 16-byte copies when every row of the tile is whole and aligned.
  const bool vec = k0 + KT <= k && (k * (int64_t)sizeof(T)) % 16 == 0;
  if (t < BSR_B) {
    const int64_t row = br * BSR_B + t;
    sp0[t] = row < rows ? indptr[row] : 0;
    spe[t] = row < rows ? indptr[row + 1] : 0;
  }

  auto stage_group = [&](int s) {
    const int buf = s & 1;
    const int g0 = s * G;
    const int ng = min(G, nblk - g0);
    if (t < ng) {
      sbcol[buf][t] = bcol[b0 + g0 + t];
      sflag[buf][t] = 0;
    }
    T* dst = xs + (int64_t)buf * G * CHUNK;
    if (vec) {
      for (int i = t; i < ng * CHUNK / PIECE; i += BSR_THREADS) {
        const int v = i * PIECE;
        const int g = v / CHUNK, c = (v / KT) % BSR_B, j = v % KT;
        const int64_t xrow = (int64_t)bcol[b0 + g0 + g] * BSR_B + c;
        __pipeline_memcpy_async(dst + v, X + xrow * k + k0 + j, 16);
      }
    } else {
      for (int v = t; v < ng * CHUNK; v += BSR_THREADS) {
        const int g = v / CHUNK, c = (v / KT) % BSR_B, j = v % KT;
        const int64_t xrow = (int64_t)bcol[b0 + g0 + g] * BSR_B + c;
        dst[v] = k0 + j < k ? X[xrow * k + k0 + j] : bsr_zero<T>();
      }
    }
    __pipeline_commit();
  };

  float acc[RPG];
  int64_t p[RPG];
  stage_group(0);
  __syncthreads();  // sp0/spe
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
    acc[i] = 0.f;
    p[i] = sp0[grp + i * NGRP];
  }
  for (int s = 0; s < nstage; ++s) {
    const int buf = s & 1;
    const int ng = min(G, nblk - s * G);
    if (s + 1 < nstage) {
      stage_group(s + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const T* xb = xs + (int64_t)buf * G * CHUNK;
    // Mark the chunks that hold a non-finite X (all writers store 1).
    for (int v = t; v < ng * CHUNK; v += BSR_THREADS) {
      if (!isfinite(bsr_load(xb[v]))) sflag[buf][v / CHUNK] = 1;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int r = grp + i * NGRP;
      const int64_t pe = spe[r];
      int64_t pp = p[i];
      int64_t cn = pp < pe ? (int64_t)indices[pp] : -1;  // next column
      float a = acc[i];
      for (int g = 0; g < ng; ++g) {
        const int64_t bc = sbcol[buf][g];
        const T* xc = xb + g * CHUNK + lane;
        if (!sflag[buf][g]) {
          while ((cn >> 7) == bc) {
            a = fmaf(bsr_load(data[pp]), bsr_load(xc[(cn & (BSR_B - 1)) * KT]),
                     a);
            ++pp;
            cn = pp < pe ? (int64_t)indices[pp] : -1;
          }
        } else {
          const int64_t c0 = bc * BSR_B;
          for (int c = 0; c < BSR_B; ++c) {
            const bool hit = cn == c0 + c;
            const float v = hit ? bsr_load(data[pp]) : 0.f;
            a = fmaf(v, bsr_load(xc[c * KT]), a);
            if (hit) {
              ++pp;
              cn = pp < pe ? (int64_t)indices[pp] : -1;
            }
          }
        }
      }
      acc[i] = a;
      p[i] = pp;
    }
    __syncthreads();  // every thread is done with this buffer
  }
  if (k0 + lane < k) {
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int64_t row = br * BSR_B + grp + i * NGRP;
      Y[row * k + k0 + lane] = acc[i];
    }
  }
}

template <typename T, typename I>
static int bsr_spmm_launch(const void* data, const void* indices,
                           const void* indptr, const void* bcol,
                           const void* bptr, const void* X, void* Y,
                           int64_t rows, int64_t nbr, int64_t k,
                           void* stream) {
  if (nbr < 0 || nbr > 0x7fffffffLL || rows < 0 || rows > nbr * BSR_B ||
      k < 1 || k > 65535LL * 16)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)X) % 16) return (int)cudaErrorMisalignedAddress;
  if (nbr == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16) {
    bsr_spmm_kernel<T, I, 16><<<dim3((unsigned)nbr, 1), BSR_THREADS, 0, st>>>(
        (const T*)data, (const I*)indices, (const int64_t*)indptr,
        (const int32_t*)bcol, (const int64_t*)bptr, (const T*)X, (float*)Y,
        rows, k);
  } else {
    const unsigned ktiles = (unsigned)((k + 31) / 32);
    bsr_spmm_kernel<T, I, 32><<<dim3((unsigned)nbr, ktiles), BSR_THREADS, 0,
                                st>>>(
        (const T*)data, (const I*)indices, (const int64_t*)indptr,
        (const int32_t*)bcol, (const int64_t*)bptr, (const T*)X, (float*)Y,
        rows, k);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int bsr_spmm_index(int idx_bytes, const void* data, const void* indices,
                          const void* indptr, const void* bcol,
                          const void* bptr, const void* X, void* Y,
                          int64_t rows, int64_t nbr, int64_t k, void* stream) {
  switch (idx_bytes) {
    case 2:
      return bsr_spmm_launch<T, int16_t>(data, indices, indptr, bcol, bptr, X,
                                         Y, rows, nbr, k, stream);
    case 4:
      return bsr_spmm_launch<T, int32_t>(data, indices, indptr, bcol, bptr, X,
                                         Y, rows, nbr, k, stream);
    case 8:
      return bsr_spmm_launch<T, int64_t>(data, indices, indptr, bcol, bptr, X,
                                         Y, rows, nbr, k, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// bf16: values and X are bf16 (else f32); idx_bytes: the column index
// width, 2 (int16, compressed storage), 4 (int32) or 8 (int64).  Returns
// the cudaError of the launch.
extern "C" int bsr_spmm(int bf16, int idx_bytes, const void* data,
                        const void* indices, const void* indptr,
                        const void* bcol, const void* bptr, const void* X,
                        void* Y, int64_t rows, int64_t nbr, int64_t k,
                        void* stream) {
  return bf16 ? bsr_spmm_index<__nv_bfloat16>(idx_bytes, data, indices,
                                              indptr, bcol, bptr, X, Y, rows,
                                              nbr, k, stream)
              : bsr_spmm_index<float>(idx_bytes, data, indices, indptr, bcol,
                                      bptr, X, Y, rows, nbr, k, stream);
}
