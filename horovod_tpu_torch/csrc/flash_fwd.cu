// Flash-attention forward for Hopper (sm_90a), in bf16 and in f16, at head
// dims 32, 64, 128, 256 and every multiple of 128 past 256.
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
// (bf16 and f16 alike), against 67 MB (20 us at 3.35 TB/s); at D 256 68.7
// GFLOP, 69 us; at D 384 103 GFLOP, 104 us (the function's, not the
// recomputed scores').  Bytes at BERT-Large's (BH 512, S 384, D 64, full):
// 101 MB, 30 us, against 19.3 GFLOP (20 us).
//
// Design up to 256 (flash_fwd_kernel): the TPU grid ran its k axis in order
// and carried m, l and acc in VMEM scratch from one grid step to the next.
// Here one block owns a (bh, 128-row q tile) and loops over the live k tiles
// itself (128 rows up to D 128, 64 at D 256, where Q's 64 KB and a ring of
// two 128-row K and V tiles would pass the 227 KB a block may hold).  The
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
// (the transpose bit), O's accumulator rescaled by corr in registers (at
// D 256 O is m64n256: 128 f32 registers a consumer thread, S 32, P 16).
// Tiles are 64-col (128-byte) swizzled panels, the layout both TMA and
// wgmma read without bank conflicts (D 32: one 64-byte panel).  O/l goes
// back through the consumer's own rows of Q's tile and a TMA store, which
// drops rows at or past S; 3-D tensor maps (D, S, BH) make a ragged tile
// read zeros, not the next head's rows.  Blocks run the q tiles with the
// most live k tiles first.
//
// Design past 256 (flash_fwd_wide_kernel): O is wider than one wgmma's N
// (256) and Q no longer fits beside a ring from 640 on (160 KB), so a block
// owns (bh, q tile, O panel z): columns [256 z, 256 z + W) of O, W 256, or
// 128 for the last panel of an odd multiple of 128 (384 = 256 + 128: the
// scores are formed twice, where 128-column panels formed them three
// times).  S takes every column: Q and K stream through a ring of SA stages
// in 64-column chunks (a 128-row Q chunk and a 64-row K chunk a stage), S
// summed chunk by chunk by m64n64k16 wgmma, a chunk's stage handed back as
// soon as its products are read (one group left in flight); V's panel of W
// columns comes through a second ring.  Every panel block streams the
// chunks in one order, chunk 0 first, so all blocks of a q tile form the
// same S, m, l and P bit for bit (the CUDA-core plan's invariant, as in
// flash_simt.cu), and only panel 0 writes lse.  O/l leaves from registers
// straight to device memory, rows below S only.  The softmax and PV code is
// the narrow kernel's.
//
// Left on the table: overlap inside a warpgroup of the softmax with the
// next tile's Q K^T, ping-pong scheduling of the two consumers, a
// persistent grid, a third ring stage at D <= 64, and past 256 a resident
// Q where it fits (up to 512) instead of a chunk reloaded per k tile.
#include "sm90.cuh"

namespace hvdflash {

using namespace sm90;

constexpr int BQ = 128;  // q rows per block, 64 per consumer warpgroup
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;  // the mask value of the TPU kernels
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int D>
struct FwdSmem {
  static constexpr int BK = D >= 256 ? 64 : 128;  // k rows per tile
  static constexpr size_t tile = BK * D * sizeof(T);
  static constexpr size_t q = 0;                     // BQ x D
  static constexpr size_t kv = q + BQ * D * sizeof(T);  // STAGES x (K, V)
  static constexpr size_t bar = kv + STAGES * 2 * tile;
  static constexpr size_t bytes = bar + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
};

// The k tiles of BK rows that the q tile from q0 reads.  Causal liveness,
// as in the TPU kernel: k tile t is live while t*BK <= q0 + BQ - 1.
template <int BK, bool CAUSAL>
__device__ __forceinline__ int live_tiles(int q0, int S) {
  const int nk = (S + BK - 1) / BK;
  return CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
}

// One k tile of the online softmax on a consumer thread's S registers
// (rows r0 and r0 + 8 of BK columns from k0; w0 is its warpgroup's first
// row): the mask where the tile crosses the diagonal or S, the running
// max and sum, O's N-column accumulator rescaled by corr, and P packed to
// T into pa, the layout of the PV product's A registers.
template <typename T, int BK, int N, bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&o)[N / 2],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t (&pa)[BK / 4], int r0, int w0,
                                             int k0, int c2, int S) {
  if ((CAUSAL && k0 + BK - 1 > w0) || k0 + BK > S) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8, col = k0 + 8 * j + c2 + (e & 1);
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
  for (int j = 0; j < N / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
#pragma unroll
  for (int x = 0; x < BK / 4; ++x) pa[x] = pack<T>(sc[2 * x], sc[2 * x + 1]);
}

// O (N columns) += P V: P from registers, V's BK x N tile read MN-major.
template <typename T, int BK, int N>
__device__ __forceinline__ void pv_tile(float (&o)[N / 2], const uint32_t (&pa)[BK / 4],
                                        const unsigned char* sv) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
    MmaRS<N, 1, T>::run(o, a, desc_mnmajor<N, BK>(sv, kk), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// l clamped at 1e-30 into lc, and lse = m + log(l) of the thread's rows r0
// and r0 + 8 of head bh where `write` holds and the row lies below S.
__device__ __forceinline__ void row_stats(const float (&m)[2], const float (&l)[2],
                                          float (&lc)[2], float* lse, int bh, int r0,
                                          int S, bool write) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lc[h] = fmaxf(l[h], 1e-30f);
    const int row = r0 + 8 * h;
    if (write && row < S) lse[(size_t)bh * S + row] = m[h] + logf(lc[h]);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mo,
                 float* __restrict__ lse, int S) {
  using L = FwdSmem<T, D>;
  using PB = Panels<D>;
  constexpr int BK = L::BK;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * BQ;
  const int kend = live_tiles<BK, CAUSAL>(q0, S);
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
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* sk = smem + L::kv + s * 2 * L::tile;

      float sc[BK / 2];  // S, then P: rows rl, rl + 8 of BK columns
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        MmaSS<BK, 0, 0, T>::run(sc, desc_kmajor<D, BQ>(sq, kk),
                             desc_kmajor<D, BK>(sk, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      uint32_t pa[BK / 4];
      softmax_tile<T, BK, D, CAUSAL>(sc, o, m, l, pa, q0 + rl, q0 + 64 * wg, i * BK,
                                     c2, S);
      pv_tile<T, BK, D>(o, pa, sk + L::tile);
      mbar_arrive(&empty[s]);
    }

    // Epilogue: O / l in T into this warpgroup's rows of Q's tile, then
    // one TMA store of them; lse = m + log(l).
    float lc[2];
    row_stats(m, l, lc, lse, bh, q0 + rl, S, lane % 4 == 0);
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

// Past 256: k rows per tile, columns per score chunk, score chunk stages.
constexpr int BKW = 64;
constexpr int CW = 64;
constexpr int SA = 6;

template <typename T, int W>
struct WideSmem {
  static constexpr size_t qc = BQ * CW * sizeof(T);         // a Q chunk
  static constexpr size_t chunk = qc + BKW * CW * sizeof(T);  // + a K chunk
  static constexpr size_t vt = BKW * W * sizeof(T);          // a V panel
  static constexpr size_t v = SA * chunk;  // SA x chunk, then STAGES x V panel
  static constexpr size_t bar = v + STAGES * vt;
  static constexpr size_t bytes = bar + 8 * 2 * (SA + STAGES) + 1024;  // + alignment
};

template <typename T, int W, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      T* __restrict__ out, float* __restrict__ lse, int S, int DW,
                      int z0) {
  using L = WideSmem<T, W>;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* cfull = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* cempty = cfull + SA;
  uint64_t* vfull = cempty + SA;
  uint64_t* vempty = vfull + STAGES;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * BQ;
  const int z = z0 + blockIdx.z;  // O's columns [256 z, 256 z + W)
  const int nc = DW / CW;
  const int kend = live_tiles<BKW, CAUSAL>(q0, S);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(&cfull[s], 1);
      mbar_init(&cempty[s], 256);  // every consumer thread
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: per k tile, nc score chunks, then V's panel
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int n = 0;  // chunks requested
      for (int i = 0; i < kend; ++i) {
        for (int c = 0; c < nc; ++c, ++n) {
          // one chunk order in every panel block: chunk 0 first
          const int s = n % SA, col = CW * c;
          mbar_wait(&cempty[s], ((n / SA) & 1) ^ 1);
          mbar_arrive_expect_tx(&cfull[s], L::chunk);
          unsigned char* sc = smem + s * L::chunk;
          tma_load_3d(sc, mq, &cfull[s], col, q0, bh);
          tma_load_3d(sc + L::qc, mk, &cfull[s], col, i * BKW, bh);
        }
        const int s = i % STAGES;
        mbar_wait(&vempty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&vfull[s], L::vt);
        unsigned char* sv = smem + L::v + s * L::vt;
        for (int p = 0; p < W / CW; ++p)
          tma_load_3d(sv + p * BKW * 128, mv, &vfull[s], 256 * z + CW * p, i * BKW, bh);
      }
    }
  } else {  // consumers: rows [q0 + 64 wg, q0 + 64 wg + 64), O's panel z
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rl = 64 * wg + 16 * (t / 32) + lane / 4;  // first row in the tile; +8
    const int c2 = 2 * (lane % 4);                      // first column of a pair
    float o[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    int n = 0;  // chunks consumed
    for (int i = 0; i < kend; ++i) {
      float sc[BKW / 2];  // S, then P: rows rl, rl + 8 of BKW columns
      for (int c = 0; c < nc; ++c, ++n) {
        const int s = n % SA;
        mbar_wait(&cfull[s], (n / SA) & 1);
        const unsigned char* sq = smem + s * L::chunk + 64 * wg * 128;
        const unsigned char* sk = smem + s * L::chunk + L::qc;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CW / 16; ++kk)
          MmaSS<BKW, 0, 0, T>::run(sc, desc_kmajor<CW, BQ>(sq, kk),
                                   desc_kmajor<CW, BKW>(sk, kk), c > 0 || kk > 0);
        wgmma_commit();
        if (c > 0) {  // the chunk before this one is read: its stage goes back
          wgmma_wait<1>();
          mbar_arrive(&cempty[(n - 1) % SA]);
        }
      }
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&cempty[(n - 1) % SA]);

      uint32_t pa[BKW / 4];
      softmax_tile<T, BKW, W, CAUSAL>(sc, o, m, l, pa, q0 + rl, q0 + 64 * wg, i * BKW,
                                      c2, S);
      const int s = i % STAGES;
      mbar_wait(&vfull[s], (i / STAGES) & 1);
      pv_tile<T, BKW, W>(o, pa, smem + L::v + s * L::vt);
      mbar_arrive(&vempty[s]);
    }

    // Epilogue: O / l in T straight to this panel's columns of the rows
    // below S; lse from panel 0 alone (every panel holds the same m and l).
    float lc[2];
    row_stats(m, l, lc, lse, bh, q0 + rl, S, lane % 4 == 0 && z == 0);
    T* ob = out + (size_t)bh * S * DW + 256 * z + c2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rl + 8 * h;
      if (row < S) {
#pragma unroll
        for (int j = 0; j < W / 8; ++j)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row * DW + 8 * j) =
              pack<T>(o[4 * j + 2 * h] / lc[h], o[4 * j + 2 * h + 1] / lc[h]);
      }
    }
  }
}

template <typename T, int D, bool CAUSAL>
static cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                          void* lse, int bh, int s, cudaStream_t stream) {
  using L = FwdSmem<T, D>;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err;
  if ((err = panel_map<D>(&mq, static_cast<const T*>(q), s, bh, BQ)) != cudaSuccess ||
      (err = panel_map<D>(&mk, static_cast<const T*>(k), s, bh, L::BK)) != cudaSuccess ||
      (err = panel_map<D>(&mv, static_cast<const T*>(v), s, bh, L::BK)) != cudaSuccess ||
      (err = panel_map<D>(&mo, static_cast<const T*>(o), s, bh, 64)) != cudaSuccess)
    return err;
  auto kernel = flash_fwd_kernel<T, D, CAUSAL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + BQ - 1) / BQ);
  kernel<<<grid, 384, L::bytes, stream>>>(mq, mk, mv, mo, static_cast<float*>(lse), s);
  return cudaGetLastError();
}

// O panels [z0, z0 + nz) of W columns each.
template <typename T, int W, bool CAUSAL>
static cudaError_t launch_panels(const CUtensorMap& mq, const CUtensorMap& mk,
                                 const CUtensorMap& mv, void* o, void* lse, int bh,
                                 int s, int d, int z0, int nz, cudaStream_t stream) {
  const size_t bytes = WideSmem<T, W>::bytes;
  auto kernel = flash_fwd_wide_kernel<T, W, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + BQ - 1) / BQ, nz);
  kernel<<<grid, 384, bytes, stream>>>(mq, mk, mv, static_cast<T*>(o),
                                        static_cast<float*>(lse), s, d, z0);
  return cudaGetLastError();
}

// d past 256, a multiple of 128: d / 256 panels of 256 columns, then one
// of 128 where d is an odd multiple of 128.
template <typename T, bool CAUSAL>
static cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                               void* lse, int bh, int s, int d, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = panel_map<CW>(&mq, static_cast<const T*>(q), s, bh, BQ, d)) !=
          cudaSuccess ||
      (err = panel_map<CW>(&mk, static_cast<const T*>(k), s, bh, BKW, d)) !=
          cudaSuccess ||
      (err = panel_map<CW>(&mv, static_cast<const T*>(v), s, bh, BKW, d)) !=
          cudaSuccess)
    return err;
  err = launch_panels<T, 256, CAUSAL>(mq, mk, mv, o, lse, bh, s, d, 0, d / 256, stream);
  if (err == cudaSuccess && d % 256)
    err = launch_panels<T, 128, CAUSAL>(mq, mk, mv, o, lse, bh, s, d, d / 256, 1,
                                        stream);
  return err;
}

}  // namespace hvdflash

// dtype: 1 float16, 2 bfloat16 (the codes of flash_simt.cu).  d: 32, 64,
// 128, 256, or a multiple of 128 past 256.  Returns a cudaError_t
// (cudaErrorInvalidValue for a dtype or d it does not take).
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
    HVD_FWD(T, 256)                                                      \
    default:                                                             \
      if (d > 256 && d % 128 == 0)                                       \
        return causal ? launch_wide<T, true>(q, k, v, o, lse, bh, s, d, st) \
                      : launch_wide<T, false>(q, k, v, o, lse, bh, s, d, st); \
      return (int)cudaErrorInvalidValue;                                 \
  }
  if (dtype == 1) HVD_FWD_WIDTHS(__half)
  if (dtype == 2) HVD_FWD_WIDTHS(__nv_bfloat16)
  return (int)cudaErrorInvalidValue;
#undef HVD_FWD_WIDTHS
#undef HVD_FWD
}
