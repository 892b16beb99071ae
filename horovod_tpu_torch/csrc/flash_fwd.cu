// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_attn_kernel, launched by
// _flash_attention_fwd_flat.  Same function: causal or full attention on a q
// already scaled by 1/sqrt(D); an online softmax keeps m, l and acc in f32,
// masked scores are -1e30, l is clamped at 1e-30, P is cast to v's dtype
// before the PV product; out: O in bf16 and the row log-sum-exp in f32.
// Tiles wholly above the diagonal are skipped.
//
// Bound on the H100 SXM: compute.  At the flagship shape (BH 32, S 2048,
// D 128, causal) the two products are 4*BH*D*S*(S+1)/2 = 34.4 GFLOP, about
// 35 us at 989 TFLOP/s bf16, against 67 MB of input and output (20 us at
// 3.35 TB/s).
//
// Design: the TPU grid ran its k axis in order and carried m, l and acc in
// scratch from one grid step to the next.  Here one block of 4 warps owns a
// (bh, 64-row q tile) and loops over the live 64-row k tiles itself.  Each
// warp owns 16 rows: it computes their scores with WMMA, runs the online
// softmax on them with warp shuffles, rescales its rows of acc and adds
// P V, so warps meet only when a new K/V tile is loaded.  acc lives in
// shared memory in f32, because the per-row rescale needs the row of every
// accumulator element, which WMMA fragments do not expose.
//
// Left on the table: wgmma and TMA (this runs on the older mma.sync path at
// a fraction of the tensor-core rate), acc in registers, double-buffered
// K/V loads (cp.async) to overlap copy with compute, exp2 with a folded
// log2(e), and a persistent schedule that balances the causal triangle.
#include "flash_common.cuh"

namespace hvdflash {

template <int D>
struct FwdSmem {
  static constexpr int H = Ld<D>::H, F = Ld<D>::F;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + 64 * H * sizeof(bf16);
  static constexpr size_t v = k + 64 * H * sizeof(bf16);
  static constexpr size_t p = v + 64 * H * sizeof(bf16);
  static constexpr size_t s = p + 64 * LDP * sizeof(bf16);
  static constexpr size_t acc = s + 64 * LDS * sizeof(float);
  static constexpr size_t m = acc + 64 * F * sizeof(float);
  static constexpr size_t l = m + 64 * sizeof(float);
  static constexpr size_t bytes = l + 64 * sizeof(float);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int S) {
  using L = FwdSmem<D>;
  constexpr int H = L::H, F = L::F;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sAcc = reinterpret_cast<float*>(smem + L::acc);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);

  const int qt = blockIdx.x, bh = blockIdx.y, q0 = qt * BQ;
  const size_t base = (size_t)bh * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's rows within the tile

  load_tile<D, 128>(sQ, q + base, q0, S);
  for (int i = threadIdx.x; i < 64 * F; i += 128) sAcc[i] = 0.f;
  if (threadIdx.x < 64) {
    sM[threadIdx.x] = NEG_INF;
    sL[threadIdx.x] = 0.f;
  }

  const int nk = (S + BK - 1) / BK;
  // Causal liveness, as in the TPU kernel: k tile t is live while
  // t*BK <= q0 + BQ - 1.
  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, 128>(sK, k + base, kt * BK, S);
    load_tile<D, 128>(sV, v + base, kt * BK, S);
    __syncthreads();

    strip_abt<D, 4>(sS + r0 * LDS, sQ + r0 * H, sK);
    __syncwarp();

    for (int r = r0; r < r0 + 16; ++r) {
      const int row = q0 + r;
      float s[2];
      float mx = NEG_INF;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = kt * BK + lane + 32 * h;
        const bool ok = col < S && (!CAUSAL || col <= row);
        s[h] = ok ? sS[r * LDS + lane + 32 * h] : NEG_INF;
        mx = fmaxf(mx, s[h]);
      }
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      const float sum = warp_sum(p0 + p1);
      const float corr = expf(m_prev - m_new);
      sP[r * LDP + lane] = __float2bfloat16(p0);
      sP[r * LDP + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < D; c += 32) sAcc[r * F + c] *= corr;
      __syncwarp();  // every lane has read sM[r]
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + sum;
      }
    }
    __syncwarp();

    // acc rows += P rows (16 x 64) @ V (64 x D)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragC c;
      wmma::load_matrix_sync(c, sAcc + r0 * F + j * 16, F, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, sP + r0 * LDP + kk, LDP);
        wmma::load_matrix_sync(b, sV + kk * H + j * 16, H);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sAcc + r0 * F + j * 16, c, F, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    if (row >= S) break;
    const float l = fmaxf(sL[r], 1e-30f);
    for (int c = lane; c < D; c += 32)
      o[base + (size_t)row * D + c] = __float2bfloat16(sAcc[r * F + c] / l);
    if (lane == 0) lse[(size_t)bh * S + row] = sM[r] + logf(l);
  }
}

template <int D, bool CAUSAL>
static cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                          float* lse, int bh, int s, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  const size_t bytes = FwdSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BQ - 1) / BQ, bh);
  kernel<<<grid, 128, bytes, stream>>>(q, k, v, o, lse, s);
  return cudaGetLastError();
}

}  // namespace hvdflash

extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int s, int d, int causal,
                             void* stream) {
  using namespace hvdflash;
  auto st = static_cast<cudaStream_t>(stream);
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto O = static_cast<bf16*>(o);
  auto LSE = static_cast<float*>(lse);
#define HVD_FWD(DD)                                                       \
  case DD:                                                                \
    return causal ? launch<DD, true>(Q, K, V, O, LSE, bh, s, st)          \
                  : launch<DD, false>(Q, K, V, O, LSE, bh, s, st);
  switch (d) {
    HVD_FWD(32)
    HVD_FWD(64)
    HVD_FWD(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HVD_FWD
}
