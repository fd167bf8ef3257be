// Copyright 2026.
// SPDX-License-Identifier: Apache-2.0
//
// Shared by the DIA SpMV and SpMM kernels (dia_spmv.cu, dia_spmm.cu):
// the offsets parameter block, the element traits, V consecutive values
// in one 16-byte load, the evict-first store and the dispatch of nd to
// an unrolled instantiation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define DIA_MAX_DIAGS 128
#define CHUNK 8  // nd above 8: chunks of CHUNK diagonals

// The offsets ride in the kernel's parameter block.
struct DiaOffsets {
  int off[DIA_MAX_DIAGS];
};

// Element traits on raw bits: values travel as their storage bits and
// are widened to f32 only for the arithmetic.  V16 values fill 16 bytes.
struct F32 {
  using Raw = unsigned int;
  static constexpr int V16 = 4;
  static __device__ __forceinline__ float val(unsigned int r) {
    return __uint_as_float(r);
  }
  static __device__ __forceinline__ float product(float a, float x) {
    return __fmul_rn(a, x);
  }
  static __device__ __forceinline__ Raw raw(float acc) {
    return __float_as_uint(acc);
  }
};

struct BF16 {
  using Raw = unsigned short;
  static constexpr int V16 = 8;
  static __device__ __forceinline__ float val(unsigned int r) {
    return __uint_as_float(r << 16);
  }
  static __device__ __forceinline__ float product(float a, float x) {
    // The exact product of two bf16 values fits in f32; rounding it to
    // bf16 once is the storage-type product the plain version takes.
    return __bfloat162float(__float2bfloat16(__fmul_rn(a, x)));
  }
  static __device__ __forceinline__ Raw raw(float acc) {
    return __bfloat16_as_ushort(__float2bfloat16(acc));
  }
};

// V consecutive values from p: one 16-byte load when V == Tr::V16 (p
// 16-byte aligned), one value when V == 1; evict-first (ld.global.cs)
// for data read once, the default policy for data read again.
template <class Tr, int V, bool EVICT_FIRST>
struct Lanes {
  unsigned int w[4];
  __device__ __forceinline__ void load(const typename Tr::Raw* p) {
    const uint4* q4 = reinterpret_cast<const uint4*>(p);
    uint4 q;
    if constexpr (EVICT_FIRST) {
      q = __ldcs(q4);
    } else {
      q = *q4;
    }
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  }
  __device__ __forceinline__ float get(int v) const {
    if constexpr (sizeof(typename Tr::Raw) == 4) {
      return Tr::val(w[v]);
    } else {
      return Tr::val((w[v >> 1] >> (16 * (v & 1))) & 0xffffu);
    }
  }
};

template <class Tr, bool EVICT_FIRST>
struct Lanes<Tr, 1, EVICT_FIRST> {
  unsigned int w;
  __device__ __forceinline__ void load(const typename Tr::Raw* p) {
    if constexpr (EVICT_FIRST) {
      w = __ldcs(p);
    } else {
      w = *p;
    }
  }
  __device__ __forceinline__ float get(int) const { return Tr::val(w); }
};

// Stores V values (16 bytes, or one value), rounded to the storage
// type, evict-first: the output is not read again by the kernel.
template <class Tr, int V>
__device__ __forceinline__ void store_cs(typename Tr::Raw* p,
                                         const float (&acc)[V]) {
  if constexpr (V == 1) {
    __stcs(p, Tr::raw(acc[0]));
  } else {
    unsigned int w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (sizeof(typename Tr::Raw) == 4) {
        w[q] = Tr::raw(acc[q]);
      } else {
        w[q] = (unsigned int)Tr::raw(acc[2 * q]) |
               ((unsigned int)Tr::raw(acc[2 * q + 1]) << 16);
      }
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
}

// Calls f(std::integral_constant<int, N>{}) with N = nd for nd 1..8, one
// unrolled instantiation each (ops/dia_kernel.py::UNROLLED_DIAGS), and
// N = 0, the chunked loop, above.
template <class F>
static void dispatch_nd(int nd, F&& f) {
  switch (nd) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    case 7: f(std::integral_constant<int, 7>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    default: f(std::integral_constant<int, 0>{}); break;
  }
}

static inline bool aligned(const void* p, unsigned n) {
  return ((uintptr_t)p % n) == 0;
}
