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
// 2,566,914,048 B, 0.7662 ms at 3.35 TB/s; two operations per band slot
// and column are far below the card's rate.
//
// What held a simple kernel back: one thread per output element, its row
// and column taken from a flat index by 64-bit division (a software
// routine of several dozen instructions), the row's band value and mask
// byte loaded again by each of the k threads of the row, X read 4 bytes
// a thread, and the x load of each diagonal waiting on its mask byte in a
// loop over a runtime number of diagonals.  So:
//
//  - a CTA is a 2-D tile: threadIdx.x runs along groups of G columns
//    (TX, a power of two up to 256, so for large k the CTA runs along k),
//    threadIdx.y along rows; the grid's x runs along rows and its y along
//    column groups.  No division anywhere;
//  - a thread owns one row and G consecutive columns (f32: 4, bf16: 8),
//    read from X and written to Y with one 16-byte access; it loads the
//    row's band value and mask byte once per diagonal for all G columns;
//  - the diagonal loop is unrolled at compile time (a template on nd up
//    to 8, above it chunks of CHUNK = 8 diagonals) and every band
//    value, mask byte and X group of a chunk is loaded before the first
//    product.  X is loaded whatever the mask says (at X[0] where the row
//    is out of range), then selected to 0 where the row is out of range
//    or the mask says hole, before the multiply, so a non-finite X row
//    that only holes reach never reaches Y;
//  - band values and mask bytes are read once: evict-first loads
//    (ld.global.cs); Y is stored evict-first; X keeps the default policy,
//    since the other diagonals read it again from L2 (at ±4096 rows and
//    k = 16 the window is 512 KB, against a 50 MB L2).
//
// The 16-byte variant needs k divisible by G and X and Y 16-byte aligned;
// the wrapper (ops/dia_kernel.py::spmm_vector_ok) chooses it, and every
// other shape (k not divisible by G, an X view off the 16-byte grid)
// takes the scalar variant (G = 1) of the same kernel.
//
// Arithmetic: each product is rounded to the storage type (f32:
// __fmul_rn; bf16: one rounding of the exact product) and summed in f32
// in offset order with __fadd_rn: the arithmetic of the plain PyTorch
// version (ops/dia_kernel.py::dia_spmm_plain), with no FMA contraction,
// so the two agree bit for bit.

#include "dia_common.cuh"

#define SPMM_MAX_K 1024

// ND > 0: exactly ND diagonals, unrolled.  ND == 0: any nd, in chunks
// of CHUNK diagonals whose loads are all in flight before their sum.
// kg is the number of column groups (k / G).
template <class Tr, int G, bool MASKED, int ND>
__global__ void __launch_bounds__(256)
    dia_spmm_kernel(const typename Tr::Raw* __restrict__ rdata,
                    const int8_t* __restrict__ rmask,
                    const typename Tr::Raw* __restrict__ X,
                    typename Tr::Raw* __restrict__ Y, int64_t rows,
                    int64_t cols, int64_t k, int kg, int nd,
                    const DiaOffsets offs) {
  constexpr int U = ND > 0 ? ND : CHUNK;
  const int cg = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (cg >= kg || i >= rows) return;
  const int64_t col0 = (int64_t)cg * G;
  const int ndiag = ND > 0 ? ND : nd;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  for (int c = 0; c < ndiag; c += U) {
    unsigned int a[U];
    int m[U];
    Lanes<Tr, G, false> xr[U];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = c + u;
      if (ND > 0 || d < nd) {
        const int64_t slot = (int64_t)d * rows + i;
        a[u] = __ldcs(rdata + slot);
        if (MASKED) m[u] = __ldcs(reinterpret_cast<const signed char*>(
                               rmask + slot));
        const int64_t j = i + offs.off[d];
        in[u] = (uint64_t)j < (uint64_t)cols;
        xr[u].load(in[u] ? X + j * k + col0 : X);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ND > 0 || c + u < nd) {
        bool valid = in[u];
        if (MASKED) valid = valid && m[u] > 0;
        const float av = Tr::val(a[u]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float xs = valid ? xr[u].get(g) : 0.f;
          acc[g] = __fadd_rn(acc[g], Tr::product(av, xs));
        }
      }
    }
  }
  store_cs<Tr, G>(Y + i * k + col0, acc);
}

template <class Tr, int G, bool MASKED>
static int launch_g(const void* rdata, const int8_t* rmask, const void* X,
                    void* Y, int64_t rows, int64_t cols, int64_t k, int nd,
                    const DiaOffsets& offs, cudaStream_t s) {
  using Raw = typename Tr::Raw;
  const int kg = (int)(k / G);
  int tx = 1;
  while (tx < kg && tx < 256) tx *= 2;
  const int ty = 256 / tx;
  const int64_t gx = (rows + ty - 1) / ty;
  if (gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)((kg + tx - 1) / tx));
  const dim3 block(tx, ty);
  auto launch = [&](auto nd_c) {
    dia_spmm_kernel<Tr, G, MASKED, decltype(nd_c)::value>
        <<<grid, block, 0, s>>>((const Raw*)rdata, rmask, (const Raw*)X,
                                (Raw*)Y, rows, cols, k, kg, nd, offs);
  };
  if constexpr (G == 1) {  // the scalar variant: the chunked loop only
    launch(std::integral_constant<int, 0>{});
  } else {
    dispatch_nd(nd, launch);
  }
  return 0;
}

template <class Tr>
static int dia_spmm_launch(const void* rdata, const void* rmask,
                           const void* X, void* Y, int64_t rows, int64_t cols,
                           int64_t k, int nd, const int* offsets, int vec,
                           void* stream) {
  constexpr int G = Tr::V16;
  if (nd < 1 || nd > DIA_MAX_DIAGS || rows < 0 || cols < 0 || k < 1 ||
      k > SPMM_MAX_K)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (vec && (k % G != 0 || cols == 0 || !aligned(X, 16) ||
              !aligned(Y, 16)))
    return (int)cudaErrorMisalignedAddress;
  DiaOffsets offs = {};
  for (int d = 0; d < nd; ++d) offs.off[d] = offsets[d];
  // With no columns (scalar variant only) every X load is selected
  // away; it reads rdata[0].
  if (cols == 0) X = rdata;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* m = (const int8_t*)rmask;
  int err;
  if (vec && m != nullptr) {
    err = launch_g<Tr, G, true>(rdata, m, X, Y, rows, cols, k, nd, offs, s);
  } else if (vec) {
    err = launch_g<Tr, G, false>(rdata, m, X, Y, rows, cols, k, nd, offs, s);
  } else if (m != nullptr) {
    err = launch_g<Tr, 1, true>(rdata, m, X, Y, rows, cols, k, nd, offs, s);
  } else {
    err = launch_g<Tr, 1, false>(rdata, m, X, Y, rows, cols, k, nd, offs, s);
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

extern "C" int dia_spmm_f32(const void* rdata, const void* rmask,
                            const void* X, void* Y, int64_t rows,
                            int64_t cols, int64_t k, int nd,
                            const int* offsets, int vec, void* stream) {
  return dia_spmm_launch<F32>(rdata, rmask, X, Y, rows, cols, k, nd,
                              offsets, vec, stream);
}

extern "C" int dia_spmm_bf16(const void* rdata, const void* rmask,
                             const void* X, void* Y, int64_t rows,
                             int64_t cols, int64_t k, int nd,
                             const int* offsets, int vec, void* stream) {
  return dia_spmm_launch<BF16>(rdata, rmask, X, Y, rows, cols, k, nd,
                               offsets, vec, stream);
}
