// Copyright 2026.
// SPDX-License-Identifier: Apache-2.0
//
// Banded (DIA) SpMV for Hopper (sm_90a).
//
// Replaces: legate_sparse_tpu/ops/pallas_dia.py::pallas_dia_spmv, the
// Pallas kernel behind csr_array.dot's banded path.
//
// Bound: bytes.  Per output row the kernel reads nd band values (4 B in
// f32, 2 B in bf16), nd mask bytes when the band has holes, the x values
// (each read once from device memory, reused from cache by the other
// diagonals and the neighbouring rows) and writes one y value.  Two
// operations per band slot are nothing beside that.  For the 5-diagonal
// masked f32 Poisson operator at 2^24 rows that is ~554 MB, ~0.165 ms at
// the H100's 3.35 TB/s.
//
// Design: the row-aligned layout rdata[d, i] = A[i, i + off_d] is a plain
// (nd, rows) array, so one thread per output row reads rdata[d, i], the
// mask and x[i + off_d] at addresses that the threads of a warp make
// contiguous: every load is coalesced, whatever the offset.  A grid-stride
// loop covers any row count with a fixed grid.  The offsets ride in the
// kernel's parameter block.  x is zeroed before the multiply outside
// [0, cols) and at band holes, so a non-finite x never reaches a row that
// does not store its column.  The product is rounded to the storage type
// (f32: __fmul_rn; bf16: one rounding of the exact product) and summed in
// f32 in offset order with __fadd_rn: exactly the arithmetic of the plain
// PyTorch version (ops/dia_kernel.py::dia_spmv_plain), with no FMA
// contraction, so the two agree bit for bit.

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
    dia_spmv_kernel(const T* __restrict__ rdata,
                    const int8_t* __restrict__ rmask,
                    const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                    int64_t cols, int nd, const DiaOffsets offs) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rows;
       i += stride) {
    float acc = 0.f;
    for (int d = 0; d < nd; ++d) {
      const int64_t j = i + offs.off[d];
      const int64_t slot = (int64_t)d * rows + i;
      bool valid = (j >= 0) && (j < cols);
      if (MASKED) valid = valid && (rmask[slot] > 0);
      const T xv = valid ? x[j] : DiaIo<T>::zero();
      acc = __fadd_rn(acc, DiaIo<T>::product(rdata[slot], xv));
    }
    y[i] = DiaIo<T>::out(acc);
  }
}

template <typename T>
static int dia_spmv_launch(const void* rdata, const void* rmask,
                           const void* x, void* y, int64_t rows,
                           int64_t cols, int nd, const int* offsets,
                           void* stream) {
  if (nd < 1 || nd > DIA_MAX_DIAGS || rows < 0 || cols < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  DiaOffsets offs = {};
  for (int d = 0; d < nd; ++d) offs.off[d] = offsets[d];
  const int threads = 256;
  int64_t blocks = (rows + threads - 1) / threads;
  // Enough resident blocks to fill 132 SMs many times over; the
  // grid-stride loop takes the rest.
  if (blocks > 132 * 64) blocks = 132 * 64;
  cudaStream_t s = (cudaStream_t)stream;
  if (rmask != nullptr) {
    dia_spmv_kernel<T, true><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)rdata, (const int8_t*)rmask, (const T*)x, (T*)y, rows, cols,
        nd, offs);
  } else {
    dia_spmv_kernel<T, false><<<(unsigned)blocks, threads, 0, s>>>(
        (const T*)rdata, nullptr, (const T*)x, (T*)y, rows, cols, nd, offs);
  }
  return (int)cudaGetLastError();
}

extern "C" int dia_spmv_f32(const void* rdata, const void* rmask,
                            const void* x, void* y, int64_t rows,
                            int64_t cols, int nd, const int* offsets,
                            void* stream) {
  return dia_spmv_launch<float>(rdata, rmask, x, y, rows, cols, nd, offsets,
                                stream);
}

extern "C" int dia_spmv_bf16(const void* rdata, const void* rmask,
                             const void* x, void* y, int64_t rows,
                             int64_t cols, int nd, const int* offsets,
                             void* stream) {
  return dia_spmv_launch<__nv_bfloat16>(rdata, rmask, x, y, rows, cols, nd,
                                        offsets, stream);
}
