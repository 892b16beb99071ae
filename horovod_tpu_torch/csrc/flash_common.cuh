// Shared pieces of the WMMA flash-attention backward kernels of
// flash_bwd.cu (dq, dk/dv); flash_fwd.cu and flash_bwd_onepass.cu build
// on sm90.cuh instead.
//
// Layout: q, k, v, o, g are (BH, S, D) row-major bf16; lse and delta are
// (BH, S) f32.  q arrives pre-scaled by 1/sqrt(D); the kernels do no
// scaling.  Tiles are 64 rows of q and 64 rows of k; a ragged last tile
// is zero-filled on load and masked in the scores, so any S works.
// Products run on the tensor cores as WMMA bf16 16x16x16 tiles with f32
// accumulation, from shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace hvdflash {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BQ = 64;             // rows of q per tile
constexpr int BK = 64;             // rows of k per tile
constexpr int LDS = BK + 4;        // f32 score tiles, padded against bank conflicts
constexpr int LDP = BK + 8;        // bf16 probability tiles

template <int D>
struct Ld {
  static constexpr int H = D + 8;  // bf16 (rows, D) tiles
  static constexpr int F = D + 4;  // f32 (rows, D) tiles
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Rows [row0, row0 + 64) of one (S, D) matrix into shared memory with
// leading dimension D + 8; rows at or past S are zero.  16 bytes a thread.
template <int D, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int S) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * Ld<D>::H + c) = val;
  }
}

// 64 per-row f32 values (lse or delta) of rows [row0, row0 + 64); 0 past S.
template <int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0,
                                          int S) {
  for (int i = threadIdx.x; i < 64; i += NT)
    dst[i] = row0 + i < S ? src[row0 + i] : 0.f;
}

// C (16 x 16*N strip, ld LDS) = A (16 x D rows of a, ld H) @ B^T, where B
// is 16*N rows of (rows, D) with ld H: the score products q k^T and g v^T.
template <int D, int N>
__device__ __forceinline__ void strip_abt(float* c, const bf16* a, const bf16* b) {
  FragC acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, Ld<D>::H);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      FragBT fb;
      wmma::load_matrix_sync(fb, b + j * 16 * Ld<D>::H + kk, Ld<D>::H);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    wmma::store_matrix_sync(c + j * 16, acc[j], LDS, wmma::mem_row_major);
}

}  // namespace hvdflash
