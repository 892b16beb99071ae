// Flash-attention forward for Hopper (sm_90a), in bf16 and in f16.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_attn_kernel, launched by
// _flash_attention_fwd_flat, at bf16 and f16 inputs.  Same function:
// causal or full attention on a q already scaled by 1/sqrt(D); products of
// inputs in T (bf16 or f16) with f32 accumulation; an online softmax keeps
// m, l and acc in f32, masked scores are -1e30, l is clamped at 1e-30, P is
// cast to v's dtype (T) at the running max before the PV product, as the
// TPU kernel casts it; out: O in T and the row log-sum-exp in f32,
// natural-log units.  Tiles wholly above the diagonal are skipped.  No
// conversion flushes an f16 subnormal to zero (no .ftz, no fast math).
//
// Bound on the H100 SXM: compute at the decoder's shape (BH 32, S 2048,
// D 128, causal): 4*BH*D*S*(S+1)/2 = 34.4 GFLOP, 35 us at 989 TFLOP/s
// (bf16 and f16 alike), against 67 MB (20 us at 3.35 TB/s).  Bytes at
// BERT-Large's (BH 512, S 384, D 64, full): 101 MB, 30 us, against 19.3
// GFLOP (20 us).
//
// Design: the TPU grid ran its k axis in order and carried m, l and acc in
// VMEM scratch from one grid step to the next.  Here one block owns a (bh,
// 128-row q tile) and loops over the live 128-row k tiles itself.  The
// block is three warpgroups.  The third is the producer: it gives up
// registers (setmaxnreg) and one of its threads starts TMA loads, Q once
// and K/V through a ring of two stages, each with a "full" mbarrier (the
// bytes landed) and an "empty" one (both consumers are done with it).  The
// first two are consumers, 64 q rows each: S = Q K^T by wgmma from shared
// memory into f32 registers; the online softmax on those registers (the
// row max and sum from two quad shuffles, exp2 of s*log2e - m*log2e, the
// mask only on the diagonal tile and a ragged last one); P packed to T
// in registers straight from S's accumulator layout, which is the layout
// of wgmma's register A operand; O += P V by wgmma with V read MN-major
// (the transpose bit), O's accumulator rescaled by corr in registers.
// Tiles are 64-col (128-byte) swizzled panels, the layout both TMA and
// wgmma read without bank conflicts (D 32: one 64-byte panel).  O/l goes
// back through the consumer's own rows of Q's tile and a TMA store, which
// drops rows at or past S; 3-D tensor maps (D, S, BH) make a ragged tile
// read zeros, not the next head's rows.  Blocks run the q tiles with the
// most live k tiles first.
//
// Left on the table: overlap inside a warpgroup of the softmax with the
// next tile's Q K^T, ping-pong scheduling of the two consumers, a
// persistent grid, and a third ring stage at D <= 64.
#include "sm90.cuh"

namespace hvdflash {

using namespace sm90;

constexpr int BQ = 128;  // q rows per block, 64 per consumer warpgroup
constexpr int BK = 128;  // k rows per tile
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;  // the mask value of the TPU kernels
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int D>
struct FwdSmem {
  static constexpr size_t tile = BK * D * sizeof(T);
  static constexpr size_t q = 0;                     // BQ x D
  static constexpr size_t kv = q + BQ * D * sizeof(T);  // STAGES x (K, V)
  static constexpr size_t bar = kv + STAGES * 2 * tile;
  static constexpr size_t bytes = bar + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mo,
                 float* __restrict__ lse, int S) {
  using L = FwdSmem<T, D>;
  using PB = Panels<D>;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * BQ;
  const int nk = (S + BK - 1) / BK;
  // Causal liveness, as in the TPU kernel: k tile t is live while
  // t*BK <= q0 + BQ - 1.
  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, BQ * D * sizeof(T));
      for (int p = 0; p < PB::NP; ++p)
        tma_load_3d(smem + L::q + p * BQ * PB::SWZ, mq, q_full, p * PB::PC, q0, bh);
      for (int i = 0; i < kend; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::tile);
        unsigned char* sk = smem + L::kv + s * 2 * L::tile;
        for (int p = 0; p < PB::NP; ++p) {
          tma_load_3d(sk + p * BK * PB::SWZ, mk, &full[s], p * PB::PC, i * BK, bh);
          tma_load_3d(sk + L::tile + p * BK * PB::SWZ, mv, &full[s], p * PB::PC,
                      i * BK, bh);
        }
      }
    }
  } else {  // consumers: rows [q0 + 64 wg, q0 + 64 wg + 64)
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rl = 64 * wg + 16 * (t / 32) + lane / 4;  // first row in the tile; +8
    const int c2 = 2 * (lane % 4);                      // first column of a pair
    unsigned char* sq = smem + L::q + 64 * wg * PB::SWZ;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < kend; ++i) {
      const int s = i % STAGES, k0 = i * BK;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* sk = smem + L::kv + s * 2 * L::tile;
      const unsigned char* sv = sk + L::tile;

      float sc[BK / 2];  // S, then P: rows rl, rl + 8 of 128 columns
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        MmaSS<BK, 0, 0, T>::run(sc, desc_kmajor<D, BQ>(sq, kk),
                             desc_kmajor<D, BK>(sk, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      if ((CAUSAL && k0 + BK - 1 > q0 + 64 * wg) || k0 + BK > S) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + rl + (e >> 1) * 8, col = k0 + 8 * j + c2 + (e & 1);
            if (!(col < S && (!CAUSAL || col <= row))) sc[4 * j + e] = NEG_INF;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float corr[2], ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f((m[h] - mx[h]) * LOG2E);
        m[h] = mx[h];
        ms[h] = mx[h] * LOG2E;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(sc[4 * j + e], LOG2E, -ms[e >> 1]));
          sc[4 * j + e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * corr[h] + sum[h];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // O += P V: P packed to T in registers (the A operand's layout
      // is S's accumulator layout), V MN-major
      uint32_t pa[BK / 4];
#pragma unroll
      for (int x = 0; x < BK / 4; ++x) pa[x] = pack<T>(sc[2 * x], sc[2 * x + 1]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        MmaRS<D, 1, T>::run(o, a, desc_mnmajor<D, BK>(sv, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[s]);
    }

    // Epilogue: O / l in T into this warpgroup's rows of Q's tile, then
    // one TMA store of them; lse = m + log(l).
    float lc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lc[h] = fmaxf(l[h], 1e-30f);
      const int row = q0 + rl + 8 * h;
      if (lane % 4 == 0 && row < S) lse[(size_t)bh * S + row] = m[h] + logf(lc[h]);
    }
    unsigned char* so = smem + L::q;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(so + panel_offset<D, BQ>(rl + 8 * h, 8 * j + c2)) =
            pack<T>(o[4 * j + 2 * h] / lc[h], o[4 * j + 2 * h + 1] / lc[h]);
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (t == 0 && q0 + 64 * wg < S) {
      for (int p = 0; p < PB::NP; ++p)
        tma_store_3d(mo, sq + p * BQ * PB::SWZ, p * PB::PC, q0 + 64 * wg, bh);
      tma_store_commit();
      tma_store_wait_read<0>();
    }
  }
}

template <typename T, int D, bool CAUSAL>
static cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                          void* lse, int bh, int s, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err;
  if ((err = panel_map<D>(&mq, static_cast<const T*>(q), s, bh, BQ)) != cudaSuccess ||
      (err = panel_map<D>(&mk, static_cast<const T*>(k), s, bh, BK)) != cudaSuccess ||
      (err = panel_map<D>(&mv, static_cast<const T*>(v), s, bh, BK)) != cudaSuccess ||
      (err = panel_map<D>(&mo, static_cast<const T*>(o), s, bh, 64)) != cudaSuccess)
    return err;
  auto kernel = flash_fwd_kernel<T, D, CAUSAL>;
  const size_t bytes = FwdSmem<T, D>::bytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + BQ - 1) / BQ);
  kernel<<<grid, 384, bytes, stream>>>(mq, mk, mv, mo, static_cast<float*>(lse), s);
  return cudaGetLastError();
}

}  // namespace hvdflash

// dtype: 1 float16, 2 bfloat16 (the codes of flash_simt.cu).  d: 32, 64 or
// 128.  Returns a cudaError_t (cudaErrorInvalidValue for a dtype or d it
// does not take).
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int s, int d, int causal,
                             int dtype, void* stream) {
  using namespace hvdflash;
  auto st = static_cast<cudaStream_t>(stream);
#define HVD_FWD(T, DD)                                                   \
  case DD:                                                               \
    return causal ? launch<T, DD, true>(q, k, v, o, lse, bh, s, st)      \
                  : launch<T, DD, false>(q, k, v, o, lse, bh, s, st);
#define HVD_FWD_WIDTHS(T)                                                \
  switch (d) {                                                           \
    HVD_FWD(T, 32)                                                       \
    HVD_FWD(T, 64)                                                       \
    HVD_FWD(T, 128)                                                      \
    default:                                                             \
      return (int)cudaErrorInvalidValue;                                 \
  }
  if (dtype == 1) HVD_FWD_WIDTHS(__half)
  if (dtype == 2) HVD_FWD_WIDTHS(__nv_bfloat16)
  return (int)cudaErrorInvalidValue;
#undef HVD_FWD_WIDTHS
#undef HVD_FWD
}
