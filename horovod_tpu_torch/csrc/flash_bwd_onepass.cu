// Flash-attention one-pass backward for Hopper (sm_90a): dk, dv and the f32
// dq partials in one kernel.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_bwd_onepass_kernel,
// launched by _flash_attention_bwd_onepass_flat (HVD_TPU_FLASH_BWD=
// pallas_onepass).  Same function as flash_bwd.cu's two kernels, with q
// pre-scaled by 1/sqrt(D):
//   p  = exp(q k^T - lse), 0 where masked
//   ds = p * (g v^T - delta)            (delta = rowsum(g * o), from the caller)
//   dv = p^T g     (p cast to g's dtype), summed over the q tiles in f32
//   dk = ds^T q    (ds cast to q's dtype), likewise
//   dqp[bh, t] = ds[:, k tile t] k[k tile t]   (ds cast to k's dtype, f32 out)
// dqp is (BH, nk, S, D) f32, one (S, D) slot per 64-row k tile; the caller
// sums the slots (partials.sum(1)) as the TPU path sums them in XLA.  q
// tiles wholly above the causal diagonal of a k tile write zeros in its
// slot; rows at or past S are not written.
//
// Bound on the H100 SXM: bytes at D 64.  Five products of 2*D flop per
// live (q, k) pair against the inputs, dk and dv, and nk times dq's size
// in f32 partials.  At BERT-Large's attention (BH 512, S 384, D 64, full,
// nk 6): 48.3 GFLOP (49 us at 989 TFLOP/s bf16) against 302 MB of
// partials plus 151 MB of q, k, v, g, dk and dv (135 us at 3.35 TB/s).
//
// Design: the TPU kernel kept this k tile's dk and dv in VMEM scratch
// across the sequential q axis of its grid.  Here one block of 8 warps
// owns one (bh, 64-row k tile) and loops over the live q tiles, as
// flash_bwd.cu's dkv kernel does: warps 0-3 own 16 rows of dv each and
// warps 4-7 16 rows of dk, in WMMA accumulator fragments for the whole
// loop.  Each q tile's dq partial (64 x D) is a fresh product, split over
// the 8 warps as 16 rows x D/2 columns, staged in shared memory and
// written with 16-byte stores.  Every block writes only its own slot, so
// there are no atomics and the partials repeat bit for bit.
//
// Left on the table: wgmma and TMA, double-buffered loads, scores kept in
// registers, and the atomic-add dq variant, which would trade the nk-fold
// partial traffic for float atomics.
#include "flash_common.cuh"

namespace hvdflash {

template <int D>
struct OnepassSmem {
  static constexpr int H = Ld<D>::H;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + 64 * H * sizeof(bf16);
  static constexpr size_t q = v + 64 * H * sizeof(bf16);
  static constexpr size_t g = q + 64 * H * sizeof(bf16);
  static constexpr size_t p = g + 64 * H * sizeof(bf16);
  static constexpr size_t ds = p + 64 * LDP * sizeof(bf16);
  static constexpr size_t s = ds + 64 * LDP * sizeof(bf16);  // also the f32 out tiles
  static constexpr size_t dp = s + 64 * LDS * sizeof(float);
  static constexpr size_t lse = dp + 64 * LDS * sizeof(float);
  static constexpr size_t delta = lse + 64 * sizeof(float);
  static constexpr size_t bytes = delta + 64 * sizeof(float);
  static_assert(64 * Ld<D>::F * sizeof(float) <= 2 * 64 * LDS * sizeof(float),
                "out tile must fit in the s and dp tiles");
};

// Rows [row0, row0 + 64) of an f32 (rows, D) tile (ld D + 4) to an (S, D)
// f32 matrix; rows at or past S are not written.  16 bytes a thread.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out, const float* tile,
                                               int row0, int S) {
  constexpr int F = Ld<D>::F, C4 = D / 4;
  for (int i = threadIdx.x; i < 64 * C4; i += 256) {
    const int r = i / C4, c = (i % C4) * 4;
    if (row0 + r < S)
      *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * D + c) =
          *reinterpret_cast<const float4*>(tile + r * F + c);
  }
}

template <int D>
__device__ __forceinline__ void store_rows_bf16(bf16* out, const float* tile, int k0,
                                                int S) {
  constexpr int F = Ld<D>::F;
  for (int i = threadIdx.x; i < 64 * D; i += 256) {
    const int r = i / D, c = i % D;
    if (k0 + r < S) out[(size_t)(k0 + r) * D + c] = __float2bfloat16(tile[r * F + c]);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(256)
flash_bwd_onepass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dqp,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S) {
  using L = OnepassSmem<D>;
  constexpr int H = L::H, F = Ld<D>::F;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::g);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);
  float* sOut = sS;  // free once p and ds are written: the f32 out tiles

  const int kt = blockIdx.x, nk = gridDim.x, bh = blockIdx.y, k0 = kt * BK;
  const size_t base = (size_t)bh * S * D;
  float* slot = dqp + ((size_t)bh * nk + kt) * S * D;  // this k tile's partial
  const int warp = threadIdx.x / 32;
  const int strip = (warp % 4) * 16;  // 16 rows of the 64-row tile
  const bool is_dk = warp >= 4;       // warps 0-3: dv (and s); 4-7: dk (and dp)
  const int half = (warp / 4) * (D / 2);  // this warp's dq partial columns

  load_tile<D, 256>(sK, k + base, k0, S);
  load_tile<D, 256>(sV, v + base, k0, S);

  // q tiles before qstart lie wholly above the causal diagonal of this k
  // tile: their rows of the slot are zero (all of them < k0 <= S).
  const int nq = (S + BQ - 1) / BQ;
  const int qstart = CAUSAL ? k0 / BQ : 0;
  for (size_t i = threadIdx.x; i < (size_t)qstart * BQ * D / 4; i += 256)
    reinterpret_cast<float4*>(slot)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int qt = qstart; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<D, 256>(sQ, q + base, q0, S);
    load_tile<D, 256>(sG, g + base, q0, S);
    load_rows<256>(sLse, lse + (size_t)bh * S, q0, S);
    load_rows<256>(sDelta, delta + (size_t)bh * S, q0, S);
    __syncthreads();

    // s = q k^T (warps 0-3) and dp = g v^T (warps 4-7), 16 q rows each
    if (is_dk)
      strip_abt<D, 4>(sDP + strip * LDS, sG + strip * H, sV);
    else
      strip_abt<D, 4>(sS + strip * LDS, sQ + strip * H, sK);
    __syncthreads();

    for (int i = threadIdx.x; i < BQ * BK; i += 256) {
      const int r = i / BK, c = i % BK;  // r: q row, c: k row of the tiles
      const int row = q0 + r, col = k0 + c;
      const bool ok = row < S && col < S && (!CAUSAL || col <= row);
      const float p = ok ? expf(sS[r * LDS + c] - sLse[r]) : 0.f;
      sP[r * LDP + c] = __float2bfloat16(p);
      sDS[r * LDP + c] = __float2bfloat16(p * (sDP[r * LDS + c] - sDelta[r]));
    }
    __syncthreads();

    // dv rows += p^T rows @ g, dk rows += ds^T rows @ q  (16 x 64 @ 64 x D)
    const bf16* at = (is_dk ? sDS : sP) + strip;
    const bf16* b = is_dk ? sQ : sG;
#pragma unroll
    for (int kk = 0; kk < BQ; kk += 16) {
      FragAT a;
      wmma::load_matrix_sync(a, at + kk * LDP, LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, b + kk * H + j * 16, H);
        wmma::mma_sync(acc[j], a, fb, acc[j]);
      }
    }

    // dq partial, rows [strip, strip + 16) x columns [half, half + D/2):
    // ds (16 x 64) @ K (64 x D/2).  Only sDS and sK are read, so the s
    // and dp tiles take the result without another barrier.
    FragC part[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) wmma::fill_fragment(part[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, sDS + strip * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, sK + kk * H + half + j * 16, H);
        wmma::mma_sync(part[j], a, fb, part[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      wmma::store_matrix_sync(sOut + strip * F + half + j * 16, part[j], F,
                              wmma::mem_row_major);
    __syncthreads();
    store_rows_f32<D>(slot, sOut, q0, S);
  }

  // Epilogue through the s and dp tiles, dv first, then dk.
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
    if (is_dk == (pass == 1)) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wmma::store_matrix_sync(sOut + strip * F + j * 16, acc[j], F,
                                wmma::mem_row_major);
    }
    __syncthreads();
    store_rows_bf16<D>((pass == 0 ? dv : dk) + base, sOut, k0, S);
  }
}

template <int D, bool CAUSAL>
static cudaError_t launch_onepass(const bf16* q, const bf16* k, const bf16* v,
                                  const bf16* g, const float* lse,
                                  const float* delta, float* dqp, bf16* dk,
                                  bf16* dv, int bh, int s, cudaStream_t stream) {
  auto kernel = flash_bwd_onepass_kernel<D, CAUSAL>;
  const size_t bytes = OnepassSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BK - 1) / BK, bh);
  kernel<<<grid, 256, bytes, stream>>>(q, k, v, g, lse, delta, dqp, dk, dv, s);
  return cudaGetLastError();
}

}  // namespace hvdflash

extern "C" int hvd_flash_bwd_onepass(const void* q, const void* k, const void* v,
                                     const void* g, const void* lse,
                                     const void* delta, void* dqp, void* dk,
                                     void* dv, int bh, int s, int d, int causal,
                                     void* stream) {
  using namespace hvdflash;
  auto st = static_cast<cudaStream_t>(stream);
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto G = static_cast<const bf16*>(g);
  auto LSE = static_cast<const float*>(lse);
  auto DEL = static_cast<const float*>(delta);
  auto DQP = static_cast<float*>(dqp);
  auto DK = static_cast<bf16*>(dk);
  auto DV = static_cast<bf16*>(dv);
#define HVD_ONEPASS(DD)                                                        \
  case DD:                                                                     \
    return causal                                                              \
        ? launch_onepass<DD, true>(Q, K, V, G, LSE, DEL, DQP, DK, DV, bh, s, st) \
        : launch_onepass<DD, false>(Q, K, V, G, LSE, DEL, DQP, DK, DV, bh, s, st);
  switch (d) {
    HVD_ONEPASS(32)
    HVD_ONEPASS(64)
    HVD_ONEPASS(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HVD_ONEPASS
}
