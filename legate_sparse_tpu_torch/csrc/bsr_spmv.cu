// Copyright 2026.
// SPDX-License-Identifier: Apache-2.0
//
// Block-sparse (BSR) SpMV for Hopper (sm_90a): y = A @ x over the present
// 128x128 blocks of a CSR matrix, reading only its stored nonzeros.
//
// Replaces: legate_sparse_tpu/ops/bsr.py::bsr_spmv_pallas, the Pallas
// kernel behind csr_array.dot's irregular path.  The Pallas kernel streams
// densified blocks through the MXU because Mosaic cannot gather single
// elements.  This kernel keeps that kernel's function, including the rule
// that the zero slots of a present block multiply x, and drops the dense
// storage: the present-block list only plans which x chunks to stage.
//
// Bound: bytes.  Each input read once: the CSR values and column indices
// (8 B per nonzero in f32 with int32 indices), indptr (int64), x and y
// (f32), bcol and bptr.  At 2^20 rows, 16 nonzeros per row and 65,536
// blocks that is 151,322,640 B, 0.04517 ms at 3.35 TB/s; the 2 flops per
// nonzero are far below the card's rate.
//
// Design: one CTA of 128 threads per block-row; thread r owns row R0 + r.
// The x chunks of the block-row's present blocks are staged in shared
// memory G = 16 at a time with cp.async into two buffers, so a block-row
// of more than G blocks loads the next group while it computes on this
// one.  While a group lands, the CTA marks each chunk that holds a
// non-finite value.
// - No chunk of the group marked (the rule): the block-row's entries,
//   one contiguous range of the CSR arrays, are staged WT = 2048 at a time
//   in shared memory with coalesced cp.async copies, the first tile
//   beside the first x group (a pad slot every 16 entries keeps threads
//   that walk 16-entry rows in step on distinct banks), and each thread
//   walks its row's part of the tile in column order.  The
//   entries fall into the group's blocks in bcol order, so the thread
//   tracks its block by comparing col >> 7 with the staged bcol, with no
//   search.  It skips the zero slots: fmaf(0, x, acc) == acc for finite x
//   (up to the sign of a zero), so the result equals the dense kernel's,
//   in the same order.  The tile is what makes the loads coalesced: a
//   thread walking its row in device memory makes every warp load touch
//   32 cache lines, one per row.
// - A marked chunk (rare): each thread walks its entries from device
//   memory, and through all 128 columns of each marked block in order
//   with fmaf(stored ? v : 0, xs[c], acc), as the dense kernel did, so
//   0 * inf gives NaN exactly where the Pallas kernel gives it.
// One thread per output row and a fixed order: deterministic, no atomics.
// y is written in f32; the wrapper casts it to the matrix dtype.
// Templated on the value type (f32, bf16) and the column index type
// (int16 for compressed storage, int32, int64).
//
// Known limits: a block-row with one much longer row holds its CTA until
// that thread is done (splitting long rows across a warp is later work);
// a block-row of more than G blocks stages its entry tiles once per group.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BSR_B 128
#define BSR_G 16    // x chunks staged per group
#define BSR_WT 2048  // CSR entries staged per tile
// Tile slot of entry j: one pad slot per 16 entries, so threads that walk
// rows of 16 entries in step read distinct banks.
#define BSR_SKEW(j) ((j) + ((j) >> 4))
#define BSR_WTS (BSR_WT + BSR_WT / 16)

static __device__ __forceinline__ float bsr_load(float v) { return v; }
static __device__ __forceinline__ float bsr_load(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename I>
__global__ void __launch_bounds__(BSR_B)
    bsr_spmv_kernel(const T* __restrict__ data, const I* __restrict__ indices,
                    const int64_t* __restrict__ indptr,
                    const int32_t* __restrict__ bcol,
                    const int64_t* __restrict__ bptr,
                    const T* __restrict__ x, float* __restrict__ y,
                    int64_t rows) {
  constexpr int PIECE = 16 / sizeof(T);      // values per 16-byte copy
  constexpr int PIECES = BSR_B / PIECE;      // copies per chunk
  // Raw bytes: a __shared__ array of a class type (bf16) is not allowed.
  __shared__ __align__(16) unsigned char xs_raw[2 * BSR_G * BSR_B * sizeof(T)];
  T(*xs)[BSR_G][BSR_B] = reinterpret_cast<T(*)[BSR_G][BSR_B]>(xs_raw);
  __shared__ int32_t sbcol[2][BSR_G];
  __shared__ int32_t sflag[2][BSR_G];
  __shared__ I sidx[BSR_WTS];
  __shared__ __align__(16) unsigned char sval_raw[BSR_WTS * sizeof(T)];
  T* sval = reinterpret_cast<T*>(sval_raw);
  const int64_t br = blockIdx.x;
  const int r = threadIdx.x;
  const int64_t b0 = bptr[br];
  const int nblk = (int)(bptr[br + 1] - b0);
  const int nstage = (nblk + BSR_G - 1) / BSR_G;
  const int64_t row = br * BSR_B + r;
  // The block-row's entries are one contiguous range [e0, e1).
  const int64_t e0 = indptr[br * BSR_B];
  const int64_t e1 = indptr[min(br * BSR_B + BSR_B, rows)];
  int64_t p = 0, pe = 0;
  if (row < rows) {
    p = indptr[row];
    pe = indptr[row + 1];
  }
  float acc = 0.f;

  auto stage_group = [&](int s) {
    const int buf = s & 1;
    const int g0 = s * BSR_G;
    const int ng = min(BSR_G, nblk - g0);
    if (r < ng) {
      sbcol[buf][r] = bcol[b0 + g0 + r];
      sflag[buf][r] = 0;
    }
    for (int i = r; i < ng * PIECES; i += BSR_B) {
      const int g = i / PIECES, q = i - g * PIECES;
      const T* src = x + (int64_t)bcol[b0 + g0 + g] * BSR_B + q * PIECE;
      __pipeline_memcpy_async(&xs[buf][g][q * PIECE], src, 16);
    }
    __pipeline_commit();
  };

  // Stage entries [t0, t0 + n) of the block-row in the tile.
  auto load_tile = [&](int64_t t0, int n) {
    for (int j = r; j < n; j += BSR_B) {
      // cp.async copies 4, 8 or 16 bytes: a 2-byte index (int16) or
      // value (bf16) is loaded and stored by the thread.
      if constexpr (sizeof(I) >= 4)
        __pipeline_memcpy_async(&sidx[BSR_SKEW(j)], &indices[t0 + j],
                                sizeof(I));
      else
        sidx[BSR_SKEW(j)] = indices[t0 + j];
      if (sizeof(T) == 4)
        __pipeline_memcpy_async(&sval[BSR_SKEW(j)], &data[t0 + j], 4);
      else
        sval[BSR_SKEW(j)] = data[t0 + j];
    }
    __pipeline_commit();
  };

  // The first tile loads beside the first x group.
  stage_group(0);
  load_tile(e0, (int)min((int64_t)BSR_WT, e1 - e0));
  for (int s = 0; s < nstage; ++s) {
    const int buf = s & 1;
    const int ng = min(BSR_G, nblk - s * BSR_G);
    if (s + 1 < nstage) {
      stage_group(s + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    // Mark the chunks that hold a non-finite x (all writers store 1).
    for (int i = r; i < ng * BSR_B; i += BSR_B) {
      if (!isfinite(bsr_load(xs[buf][i / BSR_B][i % BSR_B])))
        sflag[buf][i / BSR_B] = 1;
    }
    __syncthreads();
    bool marked = false;
    for (int g = 0; g < ng; ++g) marked |= sflag[buf][g] != 0;
    const int last_bc = sbcol[buf][ng - 1];
    if (!marked) {
      // Fast path: the entries are staged a tile at a time with
      // coalesced loads, and each thread walks its row's part of the
      // tile, skipping the zero slots.
      for (int64_t t0 = e0; t0 < e1; t0 += BSR_WT) {
        const int n = (int)min((int64_t)BSR_WT, e1 - t0);
        if (s > 0 || t0 > e0) {
          load_tile(t0, n);
          __pipeline_wait_prior(0);
          __syncthreads();
        }
        const int64_t lim = min(pe, t0 + n);
        if (p >= t0) {
          int g = 0;
          while (p < lim) {
            const int q = BSR_SKEW((int)(p - t0));
            const int64_t c = (int64_t)sidx[q];
            const int bc = (int)(c >> 7);
            if (bc > last_bc) break;  // a later group's block
            while (sbcol[buf][g] < bc) ++g;
            acc = fmaf(bsr_load(sval[q]), bsr_load(xs[buf][g][c & (BSR_B - 1)]),
                       acc);
            ++p;
          }
        }
        __syncthreads();  // every thread is done with this tile
      }
    } else {
      // A chunk holds inf or NaN: walk from device memory, and through
      // all 128 columns of each marked block.
      int64_t cn = p < pe ? (int64_t)indices[p] : -1;  // next column
      for (int g = 0; g < ng; ++g) {
        const int64_t bc = sbcol[buf][g];
        const T* xc = xs[buf][g];
        if (!sflag[buf][g]) {
          while ((cn >> 7) == bc) {
            acc = fmaf(bsr_load(data[p]), bsr_load(xc[cn & (BSR_B - 1)]), acc);
            ++p;
            cn = p < pe ? (int64_t)indices[p] : -1;
          }
        } else {
          const int64_t c0 = bc * BSR_B;
          for (int c = 0; c < BSR_B; ++c) {
            const bool hit = cn == c0 + c;
            const float v = hit ? bsr_load(data[p]) : 0.f;
            acc = fmaf(v, bsr_load(xc[c]), acc);
            if (hit) {
              ++p;
              cn = p < pe ? (int64_t)indices[p] : -1;
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer
  }
  y[row] = acc;
}

template <typename T, typename I>
static int bsr_spmv_launch(const void* data, const void* indices,
                           const void* indptr, const void* bcol,
                           const void* bptr, const void* x, void* y,
                           int64_t rows, int64_t nbr, void* stream) {
  if (nbr < 0 || nbr > 0x7fffffffLL || rows < 0 || rows > nbr * BSR_B)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x) % 16) return (int)cudaErrorMisalignedAddress;
  if (nbr == 0) return 0;
  bsr_spmv_kernel<T, I><<<(unsigned)nbr, BSR_B, 0, (cudaStream_t)stream>>>(
      (const T*)data, (const I*)indices, (const int64_t*)indptr,
      (const int32_t*)bcol, (const int64_t*)bptr, (const T*)x, (float*)y,
      rows);
  return (int)cudaGetLastError();
}

template <typename T>
static int bsr_spmv_index(int idx_bytes, const void* data, const void* indices,
                          const void* indptr, const void* bcol,
                          const void* bptr, const void* x, void* y,
                          int64_t rows, int64_t nbr, void* stream) {
  switch (idx_bytes) {
    case 2:
      return bsr_spmv_launch<T, int16_t>(data, indices, indptr, bcol, bptr, x,
                                         y, rows, nbr, stream);
    case 4:
      return bsr_spmv_launch<T, int32_t>(data, indices, indptr, bcol, bptr, x,
                                         y, rows, nbr, stream);
    case 8:
      return bsr_spmv_launch<T, int64_t>(data, indices, indptr, bcol, bptr, x,
                                         y, rows, nbr, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// bf16: values and x are bf16 (else f32); idx_bytes: the column index
// width, 2 (int16, compressed storage), 4 (int32) or 8 (int64).  Returns
// the cudaError of the launch.
extern "C" int bsr_spmv(int bf16, int idx_bytes, const void* data,
                        const void* indices, const void* indptr,
                        const void* bcol, const void* bptr, const void* x,
                        void* y, int64_t rows, int64_t nbr, void* stream) {
  return bf16 ? bsr_spmv_index<__nv_bfloat16>(idx_bytes, data, indices,
                                              indptr, bcol, bptr, x, y, rows,
                                              nbr, stream)
              : bsr_spmv_index<float>(idx_bytes, data, indices, indptr, bcol,
                                      bptr, x, y, rows, nbr, stream);
}
