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
// masked f32 Poisson operator at 2^24 rows that is 553,648,128 B,
// 0.1653 ms at the H100's 3.35 TB/s.
//
// What holds a simple kernel back is latency, not bandwidth: one thread
// per row walking a runtime number of diagonals, with each x load
// predicated on the mask byte just loaded, keeps about 5 bytes of
// device-memory reads in flight per thread, where the card needs some
// 18 KB in flight per SM.  So:
//
//  - the diagonal loop is unrolled at compile time (a template on nd up
//    to 8, above it a loop over chunks of CHUNK = 8 diagonals), and
//    every band value, mask word and x value of a chunk is loaded before
//    the first product: no load waits on another load.  x is loaded at a
//    clamped in-range index whatever the mask says, then selected to 0
//    where the row is out of range or the mask says hole, before the
//    multiply, so a non-finite x that no row stores never reaches y;
//  - each thread owns V consecutive rows (f32: 4, bf16: 8): one 16-byte
//    load of each band row and one 4- or 8-byte load of its mask bytes,
//    one 16-byte store of y;
//  - band values and mask bytes are read once, so they are loaded with
//    the evict-first hint (ld.global.cs) and y is stored with it; x keeps
//    the default policy, since the other diagonals read it again from
//    L1/L2 (at ±4096 the window is 32 KB, against a 50 MB L2).
//
// The 16-byte variant needs rows divisible by V and rdata, y (16 B) and
// rmask (V B) aligned; the wrapper (ops/dia_kernel.py::spmv_vector_ok)
// chooses it and every other shape takes the scalar variant (V = 1) of
// the same kernel.  x is read with scalar loads in both, so its alignment
// does not matter.  One thread per group of V rows: no grid-stride loop.
//
// Arithmetic: each product is rounded to the storage type (f32:
// __fmul_rn; bf16: one rounding of the exact product) and summed in f32
// in offset order with __fadd_rn: exactly the arithmetic of the plain
// PyTorch version (ops/dia_kernel.py::dia_spmv_plain), with no FMA
// contraction, so the two agree bit for bit.

#include "dia_common.cuh"

// V consecutive mask bytes, loaded evict-first in one word.
template <int V>
struct MaskLanes;

template <>
struct MaskLanes<1> {
  int w;
  __device__ __forceinline__ void load(const int8_t* p) {
    w = __ldcs(reinterpret_cast<const signed char*>(p));
  }
  __device__ __forceinline__ bool get(int) const { return w > 0; }
};

template <>
struct MaskLanes<4> {
  unsigned int w;
  __device__ __forceinline__ void load(const int8_t* p) {
    w = __ldcs(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ bool get(int v) const {
    return (signed char)(w >> (8 * v)) > 0;
  }
};

template <>
struct MaskLanes<8> {
  unsigned int w[2];
  __device__ __forceinline__ void load(const int8_t* p) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
    w[0] = q.x; w[1] = q.y;
  }
  __device__ __forceinline__ bool get(int v) const {
    return (signed char)(w[v >> 2] >> (8 * (v & 3))) > 0;
  }
};

// ND > 0: exactly ND diagonals, unrolled.  ND == 0: any nd, in chunks
// of CHUNK diagonals whose loads are all in flight before their sum.
template <class Tr, int V, bool MASKED, int ND>
__global__ void __launch_bounds__(256)
    dia_spmv_kernel(const typename Tr::Raw* __restrict__ rdata,
                    const int8_t* __restrict__ rmask,
                    const typename Tr::Raw* __restrict__ x,
                    typename Tr::Raw* __restrict__ y, int64_t rows,
                    int64_t cols, int nd, const DiaOffsets offs) {
  constexpr int U = ND > 0 ? ND : CHUNK;
  const int64_t i0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i0 >= rows) return;
  const int ndiag = ND > 0 ? ND : nd;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  for (int c = 0; c < ndiag; c += U) {
    Lanes<Tr, V, true> a[U];
    MaskLanes<V> m[U];
    unsigned int xr[U][V];
    unsigned int in[U];  // bit v: row i0 + v reaches a column of x
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = c + u;
      if (ND > 0 || d < nd) {
        const int64_t slot = (int64_t)d * rows + i0;
        a[u].load(rdata + slot);
        if (MASKED) m[u].load(rmask + slot);
        const int64_t j0 = i0 + offs.off[d];
        in[u] = 0;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int64_t j = j0 + v;
          const bool ok = (uint64_t)j < (uint64_t)cols;
          in[u] |= (unsigned int)ok << v;
          xr[u][v] = x[ok ? j : 0];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ND > 0 || c + u < nd) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          bool valid = (in[u] >> v) & 1u;
          if (MASKED) valid = valid && m[u].get(v);
          const float xs = valid ? Tr::val(xr[u][v]) : 0.f;
          acc[v] = __fadd_rn(acc[v], Tr::product(a[u].get(v), xs));
        }
      }
    }
  }
  store_cs<Tr, V>(y + i0, acc);
}

template <class Tr, int V, bool MASKED>
static void launch_v(const void* rdata, const int8_t* rmask, const void* x,
                     void* y, int64_t rows, int64_t cols, int nd,
                     const DiaOffsets& offs, cudaStream_t s) {
  using Raw = typename Tr::Raw;
  const int64_t groups = (rows + V - 1) / V;
  const dim3 grid((unsigned)((groups + 255) / 256));
  auto launch = [&](auto nd_c) {
    dia_spmv_kernel<Tr, V, MASKED, decltype(nd_c)::value>
        <<<grid, 256, 0, s>>>((const Raw*)rdata, rmask, (const Raw*)x,
                              (Raw*)y, rows, cols, nd, offs);
  };
  if constexpr (V == 1) {  // the scalar variant: the chunked loop only
    launch(std::integral_constant<int, 0>{});
  } else {
    dispatch_nd(nd, launch);
  }
}

template <class Tr>
static int dia_spmv_launch(const void* rdata, const void* rmask,
                           const void* x, void* y, int64_t rows,
                           int64_t cols, int nd, const int* offsets,
                           int vec, void* stream) {
  constexpr int V = Tr::V16;
  if (nd < 1 || nd > DIA_MAX_DIAGS || rows < 0 || cols < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (rows / V >= (int64_t)256 * 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (vec && (rows % V != 0 || !aligned(rdata, 16) || !aligned(y, 16) ||
              (rmask != nullptr && !aligned(rmask, V))))
    return (int)cudaErrorMisalignedAddress;
  DiaOffsets offs = {};
  for (int d = 0; d < nd; ++d) offs.off[d] = offsets[d];
  // With no columns every x load is selected away; it reads rdata[0].
  if (cols == 0) x = rdata;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* m = (const int8_t*)rmask;
  if (vec && m != nullptr) {
    launch_v<Tr, V, true>(rdata, m, x, y, rows, cols, nd, offs, s);
  } else if (vec) {
    launch_v<Tr, V, false>(rdata, m, x, y, rows, cols, nd, offs, s);
  } else if (m != nullptr) {
    launch_v<Tr, 1, true>(rdata, m, x, y, rows, cols, nd, offs, s);
  } else {
    launch_v<Tr, 1, false>(rdata, m, x, y, rows, cols, nd, offs, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int dia_spmv_f32(const void* rdata, const void* rmask,
                            const void* x, void* y, int64_t rows,
                            int64_t cols, int nd, const int* offsets,
                            int vec, void* stream) {
  return dia_spmv_launch<F32>(rdata, rmask, x, y, rows, cols, nd, offsets,
                              vec, stream);
}

extern "C" int dia_spmv_bf16(const void* rdata, const void* rmask,
                             const void* x, void* y, int64_t rows,
                             int64_t cols, int nd, const int* offsets,
                             int vec, void* stream) {
  return dia_spmv_launch<BF16>(rdata, rmask, x, y, rows, cols, nd, offsets,
                               vec, stream);
}
