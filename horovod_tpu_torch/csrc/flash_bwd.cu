// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel, launched by _flash_attention_bwd_flat (the default
// two-pass backward).  Same function, with q pre-scaled by 1/sqrt(D):
//   p  = exp(q k^T - lse), 0 where masked
//   ds = p * (g v^T - delta)            (delta = rowsum(g * o), from the caller)
//   dq = ds k      (ds cast to k's dtype; dq in q's pre-scaled units, f32 out)
//   dv = p^T g     (p cast to g's dtype)
//   dk = ds^T q    (ds cast to q's dtype; no extra scale)
// accumulating in f32.  dq leaves the kernel in f32 so that the caller's
// multiply by 1/sqrt(D) comes before the one rounding to bf16.
//
// Bound on the H100 SXM: compute.  At the flagship shape (BH 32, S 2048,
// D 128, causal) dq does 3 products and dk/dv 4, each 2*BH*D*S*(S+1)/2
// FLOP: 51.6 + 68.8 GFLOP, about 52 + 70 us at 989 TFLOP/s bf16, against
// about 0.1 GB of input and output per kernel (30 us at 3.35 TB/s).
//
// Design: the TPU kernels ran the reduction axis in grid order and carried
// the sums in scratch.  Here the reduction is a loop inside the block, and
// no block writes what another block reads, so there are no atomics.
//   dq:   one block of 4 warps per (bh, 64-row q tile), looping over the
//         live k tiles; each warp owns 16 rows of dq, kept in WMMA
//         accumulator fragments for the whole loop.
//   dkv:  one block of 8 warps per (bh, 64-row k tile), looping over the q
//         tiles from the diagonal on; warps 0-3 own 16 rows of dv each and
//         warps 4-7 16 rows of dk, again in fragments.
// The scores and dp go through shared memory in f32 so that the softmax
// recomputation can see row and column of every element.
//
// Left on the table: wgmma and TMA, double-buffered loads, scores kept in
// registers instead of shared memory, one fused kernel that writes dq
// partials (the TPU's one-pass variant), and a schedule that balances the
// causal triangle across blocks.
#include "flash_common.cuh"

namespace hvdflash {

// ---------------------------------------------------------------- dq kernel

template <int D>
struct DqSmem {
  static constexpr int H = Ld<D>::H;
  static constexpr size_t q = 0;
  static constexpr size_t g = q + 64 * H * sizeof(bf16);
  static constexpr size_t k = g + 64 * H * sizeof(bf16);
  static constexpr size_t v = k + 64 * H * sizeof(bf16);
  static constexpr size_t ds = v + 64 * H * sizeof(bf16);
  static constexpr size_t s = ds + 64 * LDP * sizeof(bf16);  // also the epilogue's f32 dq
  static constexpr size_t dp = s + 64 * LDS * sizeof(float);
  static constexpr size_t lse = dp + 64 * LDS * sizeof(float);
  static constexpr size_t delta = lse + 64 * sizeof(float);
  static constexpr size_t bytes = delta + 64 * sizeof(float);
  static_assert(64 * Ld<D>::F * sizeof(float) <= 2 * 64 * LDS * sizeof(float),
                "epilogue tile must fit in the s and dp tiles");
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int S) {
  using L = DqSmem<D>;
  constexpr int H = L::H, F = Ld<D>::F;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::g);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  const int qt = blockIdx.x, bh = blockIdx.y, q0 = qt * BQ;
  const size_t base = (size_t)bh * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile<D, 128>(sQ, q + base, q0, S);
  load_tile<D, 128>(sG, g + base, q0, S);
  load_rows<128>(sLse, lse + (size_t)bh * S, q0, S);
  load_rows<128>(sDelta, delta + (size_t)bh * S, q0, S);

  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int nk = (S + BK - 1) / BK;
  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();
    load_tile<D, 128>(sK, k + base, kt * BK, S);
    load_tile<D, 128>(sV, v + base, kt * BK, S);
    __syncthreads();

    strip_abt<D, 4>(sS + r0 * LDS, sQ + r0 * H, sK);
    strip_abt<D, 4>(sDP + r0 * LDS, sG + r0 * H, sV);
    __syncwarp();

    for (int i = lane; i < 16 * BK; i += 32) {
      const int r = r0 + i / BK, c = i % BK;
      const int row = q0 + r, col = kt * BK + c;
      const bool ok = row < S && col < S && (!CAUSAL || col <= row);
      const float p = ok ? expf(sS[r * LDS + c] - sLse[r]) : 0.f;
      sDS[r * LDP + c] = __float2bfloat16(p * (sDP[r * LDS + c] - sDelta[r]));
    }
    __syncwarp();

    // dq rows += ds rows (16 x 64) @ K (64 x D)
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, sDS + r0 * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, sK + kk * H + j * 16, H);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }

  __syncthreads();  // the s and dp tiles become the f32 dq tile
  float* sOut = sS;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sOut + r0 * F + j * 16, acc[j], F, wmma::mem_row_major);
  __syncwarp();
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    if (row >= S) break;
    for (int c = lane; c < D; c += 32) dq[base + (size_t)row * D + c] = sOut[r * F + c];
  }
}

// --------------------------------------------------------------- dkv kernel

template <int D>
struct DkvSmem {
  static constexpr int H = Ld<D>::H;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + 64 * H * sizeof(bf16);
  static constexpr size_t q = v + 64 * H * sizeof(bf16);
  static constexpr size_t g = q + 64 * H * sizeof(bf16);
  static constexpr size_t p = g + 64 * H * sizeof(bf16);
  static constexpr size_t ds = p + 64 * LDP * sizeof(bf16);
  static constexpr size_t s = ds + 64 * LDP * sizeof(bf16);  // also the epilogue's f32 tile
  static constexpr size_t dp = s + 64 * LDS * sizeof(float);
  static constexpr size_t lse = dp + 64 * LDS * sizeof(float);
  static constexpr size_t delta = lse + 64 * sizeof(float);
  static constexpr size_t bytes = delta + 64 * sizeof(float);
  static_assert(64 * Ld<D>::F * sizeof(float) <= 2 * 64 * LDS * sizeof(float),
                "epilogue tile must fit in the s and dp tiles");
};

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
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S) {
  using L = DkvSmem<D>;
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

  const int kt = blockIdx.x, bh = blockIdx.y, k0 = kt * BK;
  const size_t base = (size_t)bh * S * D;
  const int warp = threadIdx.x / 32;
  const int strip = (warp % 4) * 16;  // 16 rows of the 64-row tile
  const bool is_dk = warp >= 4;       // warps 0-3: dv (and s); 4-7: dk (and dp)

  load_tile<D, 256>(sK, k + base, k0, S);
  load_tile<D, 256>(sV, v + base, k0, S);

  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int nq = (S + BQ - 1) / BQ;
  // Causal liveness: q tile j is live while j*BQ + BQ - 1 >= k0.
  const int qstart = CAUSAL ? k0 / BQ : 0;
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
  }

  // Epilogue through the s and dp tiles, dv first, then dk.
  float* sOut = sS;
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
static cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v,
                             const bf16* g, const float* lse, const float* delta,
                             float* dq, int bh, int s, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<D, CAUSAL>;
  const size_t bytes = DqSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BQ - 1) / BQ, bh);
  kernel<<<grid, 128, bytes, stream>>>(q, k, v, g, lse, delta, dq, s);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
static cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                              const bf16* g, const float* lse, const float* delta,
                              bf16* dk, bf16* dv, int bh, int s, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<D, CAUSAL>;
  const size_t bytes = DkvSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BK - 1) / BK, bh);
  kernel<<<grid, 256, bytes, stream>>>(q, k, v, g, lse, delta, dk, dv, s);
  return cudaGetLastError();
}

}  // namespace hvdflash

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* g, const void* lse, const void* delta,
                                void* dq, int bh, int s, int d, int causal,
                                void* stream) {
  using namespace hvdflash;
  auto st = static_cast<cudaStream_t>(stream);
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto G = static_cast<const bf16*>(g);
  auto LSE = static_cast<const float*>(lse);
  auto DEL = static_cast<const float*>(delta);
  auto DQ = static_cast<float*>(dq);
#define HVD_DQ(DD)                                                          \
  case DD:                                                                  \
    return causal ? launch_dq<DD, true>(Q, K, V, G, LSE, DEL, DQ, bh, s, st) \
                  : launch_dq<DD, false>(Q, K, V, G, LSE, DEL, DQ, bh, s, st);
  switch (d) {
    HVD_DQ(32)
    HVD_DQ(64)
    HVD_DQ(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HVD_DQ
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int s, int d,
                                 int causal, void* stream) {
  using namespace hvdflash;
  auto st = static_cast<cudaStream_t>(stream);
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto G = static_cast<const bf16*>(g);
  auto LSE = static_cast<const float*>(lse);
  auto DEL = static_cast<const float*>(delta);
  auto DK = static_cast<bf16*>(dk);
  auto DV = static_cast<bf16*>(dv);
#define HVD_DKV(DD)                                                              \
  case DD:                                                                       \
    return causal ? launch_dkv<DD, true>(Q, K, V, G, LSE, DEL, DK, DV, bh, s, st) \
                  : launch_dkv<DD, false>(Q, K, V, G, LSE, DEL, DK, DV, bh, s, st);
  switch (d) {
    HVD_DKV(32)
    HVD_DKV(64)
    HVD_DKV(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HVD_DKV
}
