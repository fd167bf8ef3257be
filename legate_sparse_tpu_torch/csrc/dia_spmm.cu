// Copyright 2026.
// SPDX-License-Identifier: Apache-2.0
//
// Banded (DIA) SpMM for Hopper (sm_90a): Y = A @ X for a dense X (cols, k).
//
// Replaces: legate_sparse_tpu/ops/pallas_dia.py::pallas_dia_spmm, the
// Pallas kernel behind csr_array.dot's banded path for a matrix operand.
//
// Bound: bytes.  Per output row the kernel reads nd band values (4 B in
// f32, 2 B in bf16) and nd mask bytes when the band has holes, each once;
// every X row is read once from device memory (the other diagonals and
// neighbouring rows find it in cache) and every Y row written once.  At
// k = 16 and 2^24 rows of the 5-diagonal masked Poisson operator that is
// ~2.57 GB, ~0.77 ms at 3.35 TB/s; two operations per band slot and
// column are far below the card's rate.
//
// Design: X and Y are row-major, so the output is one flat array of
// rows * k elements, and thread e of a grid-stride loop computes
// Y[i, c] with i = e / k, c = e % k.  A block of 256 threads covers a tile
// of ceil(256 / k) rows by all k columns (or 256 columns of one row when
// k > 256); the threads run along k, so the 32 loads of X[i + off_d, c]
// of a warp, and its 32 stores of Y, are consecutive addresses: every X
// and Y access is coalesced at any offset.  The band value rdata[d, i]
// and mask byte are the same for the k threads of one row and come from
// cache.  Offsets ride in the parameter block (at most 128, as in
// dia_spmv.cu).  X is zeroed before the multiply outside [0, cols) and
// at band holes, so a non-finite X at a hole never reaches Y.  The
// product is rounded to the storage type (f32: __fmul_rn; bf16: one
// rounding of the exact product) and summed in f32 in offset order with
// __fadd_rn: the arithmetic of the plain PyTorch version
// (ops/dia_kernel.py::dia_spmm_plain), with no FMA contraction, so the
// two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DIA_MAX_DIAGS 128

struct DiaOffsets {
  int off[DIA_MAX_DIAGS];
};

template <typename T>
struct DiaIo;

template <>
struct DiaIo<float> {
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float product(float a, float x) {
    return __fmul_rn(a, x);
  }
  static __device__ __forceinline__ float out(float acc) { return acc; }
};

template <>
struct DiaIo<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16(0.f);
  }
  static __device__ __forceinline__ float product(__nv_bfloat16 a,
                                                  __nv_bfloat16 x) {
    // The exact product of two bf16 values fits in f32; rounding it to
    // bf16 once is the storage-type product the plain version takes.
    return __bfloat162float(__float2bfloat16(
        __fmul_rn(__bfloat162float(a), __bfloat162float(x))));
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float acc) {
    return __float2bfloat16(acc);
  }
};

template <typename T, bool MASKED>
__global__ void __launch_bounds__(256)
    dia_spmm_kernel(const T* __restrict__ rdata,
                    const int8_t* __restrict__ rmask,
                    const T* __restrict__ X, T* __restrict__ Y, int64_t rows,
                    int64_t cols, int64_t k, int nd, const DiaOffsets offs) {
  const int64_t total = rows * k;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t i = e / k;
    const int64_t c = e - i * k;
    float acc = 0.f;
    for (int d = 0; d < nd; ++d) {
      const int64_t j = i + offs.off[d];
      const int64_t slot = (int64_t)d * rows + i;
      bool valid = (j >= 0) && (j < cols);
      if (MASKED) valid = valid && (rmask[slot] > 0);
      const T xv = valid ? X[j * k + c] : DiaIo<T>::zero();
      acc = __fadd_rn(acc, DiaIo<T>::product(rdata[slot], xv));
    }
    Y[e] = DiaIo<T>::out(acc);
  }
}

template <typename T>
static int dia_spmm_launch(const void* rdata, const void* rmask,
                           const void* X, void* Y, int64_t rows, int64_t cols,
                           int64_t k, int nd, const int* offsets,
                           void* stream) {
  if (nd < 1 || nd > DIA_MAX_DIAGS || rows < 0 || cols < 0 || k < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  DiaOffsets offs = {};
  for (int d = 0; d < nd; ++d) offs.off[d] = offsets[d];
  const int threads = 256;
  const int64_t total = rows * k;
  int64_t blocks = (total + threads - 1) / threads;
  // Enough resident blocks to fill 132 SMs many times over; the
  // grid-stride loop takes the rest.
  if (blocks > 132 * 64) blocks = 132 * 64;
  cudaStream_t s = (cudaStream_t)stream;
  if (rmask != nullptr) {
    dia_spmm_kernel<T, true><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)rdata, (const int8_t*)rmask, (const T*)X, (T*)Y, rows, cols,
        k, nd, offs);
  } else {
    dia_spmm_kernel<T, false><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)rdata, nullptr, (const T*)X, (T*)Y, rows, cols, k, nd,
        offs);
  }
  return (int)cudaGetLastError();
}

extern "C" int dia_spmm_f32(const void* rdata, const void* rmask,
                            const void* X, void* Y, int64_t rows,
                            int64_t cols, int64_t k, int nd,
                            const int* offsets, void* stream) {
  return dia_spmm_launch<float>(rdata, rmask, X, Y, rows, cols, k, nd,
                                offsets, stream);
}

extern "C" int dia_spmm_bf16(const void* rdata, const void* rmask,
                             const void* X, void* Y, int64_t rows,
                             int64_t cols, int64_t k, int nd,
                             const int* offsets, void* stream) {
  return dia_spmm_launch<__nv_bfloat16>(rdata, rmask, X, Y, rows, cols, k,
                                        nd, offsets, stream);
}
