// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// in bf16 and in f16, at head dims 32, 64, 128, 256 and every multiple of
// 128 past 256.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel, launched by _flash_attention_bwd_flat (the default
// two-pass backward), at bf16 and f16 inputs.  Same function, with q
// pre-scaled by 1/sqrt(D), products of inputs in T (bf16 or f16) with f32
// accumulation and every cast to T:
//   p  = exp(q k^T - lse), 0 where masked
//   ds = p * (g v^T - delta)            (delta = rowsum(g * o), from the caller)
//   dq = ds k      (ds cast to k's dtype; dq in q's pre-scaled units, f32 out)
//   dv = p^T g     (p cast to g's dtype)
//   dk = ds^T q    (ds cast to q's dtype; no extra scale)
// dq leaves the kernel in f32 so that the caller's multiply by 1/sqrt(D)
// comes before the one rounding to T.  No conversion flushes an f16
// subnormal to zero; dS underflows in f16 sooner than in bf16, where the
// plain version's cast sees the same values.
//
// Bound on the H100 SXM: compute at the decoder's shape (BH 32, S 2048,
// D 128, causal): dq does 3 products and dk/dv 4, each 2*BH*D*S*(S+1)/2
// FLOP: 51.6 + 68.8 GFLOP, 52 + 70 us at 989 TFLOP/s (bf16 and f16 alike),
// against about 0.1 GB of input and output per kernel (30 us at 3.35
// TB/s).  Bytes at BERT-Large's (BH 512, S 384, D 64, full): 152 MB each
// (45 us) against 29 + 39 GFLOP.
//
// Design: the TPU kernels ran the reduction axis in grid order and carried
// the sums in VMEM scratch.  Here the reduction is a loop inside the
// block, no block writes what another block reads (no atomics), and every
// kernel puts bh on gridDim.x, which takes 2^31 - 1 blocks (the dk/dv
// kernels' 1-D lse and delta maps take BH S below 2^31 rows), and its
// tile on gridDim.y, longest causal work first.  Each block
// is three warpgroups: a producer that gives up registers (setmaxnreg) and
// starts TMA loads from one thread through an mbarrier ring ("full": the
// bytes landed; "empty": both consumers are done with the stage), and two
// consumers that run wgmma into f32 registers.
//   dk/dv: flash_bwd_kv.cuh's body without the dq partials (the one-pass
//          kernel's body): one block per (bh, 128-row k tile), K and V
//          loaded once, Q, dO, lse and delta streamed by 64-row q tile; a
//          consumer owns 64 k rows, builds P^T and dS^T in registers and
//          adds dV += P^T dO and dK += dS^T Q by wgmma with A from
//          registers; dk and dv leave by TMA over its own rows of K and V.
//   dq:    one block per (bh, 128-row q tile), the blocks with the most
//          live k tiles first.  The producer loads Q and dO once and
//          streams K and V by k tile; a consumer owns 64 q rows and reads
//          their lse and delta once.  Per k tile: S = Q K^T and dP = dO V^T
//          by wgmma from shared memory (both operands K-major), P =
//          exp2(S log2e - lse log2e) and dS = P (dP - delta) on the
//          registers (the mask only on a diagonal or ragged tile), dS
//          packed to T in the accumulator's layout, which is wgmma's
//          register A layout, and dq += dS K with K read MN-major (the
//          transpose bit).  dq stays in f32 registers; it leaves through a
//          swizzled f32 tile in the ring, which both consumers are done
//          with then, and a TMA store that drops rows at or past S.
// 3-D tensor maps (D, S, BH) make a ragged tile read zeros, not the next
// head's rows.  Both kernels are templates on T: sm90.cuh's Elem<T> names
// the maps' element type and the wgmma kind, and pack<T> rounds dS and P.
//
// At D 256 (Gemma 7B's head width, and every head dim in 129-255 padded to
// it) neither plan fits: a dk/dv consumer would hold dK and dV for 64 rows
// of 256 columns (256 f32 registers a thread, over the 255 a thread has),
// and K and V at 128 rows beside a two-stage ring of Q and dO (256 KB), or
// dq's resident Q and dO beside a ring of 128-row K and V tiles (384 KB),
// pass the 227 KB a block may hold.  Bound at the hd256 decoder's shape
// (BH 32, S 2048, D 256, causal): 103.1 + 137.5 GFLOP, 104 + 139 us.
// Blocks start in gridDim.x order, so the card's first blocks span every
// head at the longest tile.  A head-major order (a head's blocks side by
// side, sharing its re-read tiles in L2) took longer in both kernels at
// the hd256 decoder's shape (PERF.md §6; tools/chip_simt_probe.py
// --wide-bwd against --wide-bwd --head-major).
//   dk/dv (flash_bwd_dkv_d256_kernel, body flash_bwd_kv.cuh's
//          kv256::kblock_body, which the one-pass kernel at 256 shares):
//          one block per (bh, 64-row k block), and its two consumers split
//          the products, not the rows: per 64-row q tile consumer 0 forms
//          S^T = K Q^T, P^T (masked) and dV += P^T dO, consumer 1 dP^T =
//          V dO^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q; each owns
//          one m64n256 f32 accumulator (128 registers) and does half the
//          products.  P^T crosses in f32 through a 16 KB exchange tile
//          under two mbarriers (written, read).  Shared memory: 210 KB.
//   dq     (flash_bwd_dq_kernel's wide plan, dqtile::Plan): the kernel
//          above with 64-row K and V tiles, one to a slot of a ring of
//          three 32 KB slots beside the resident Q and dO (128 KB), V_i
//          before K_i: dP frees V's slot early in a tile and dS K frees K's
//          at its end, so each slot is refilled a tile ahead of its use
//          (224 KB).  A consumer owns 64 q rows and all 256 columns of dq
//          (128 registers, S and dP 32 each, packed dS 16); dq leaves from
//          registers straight to the rows below S, since no 64 KB f32 tile
//          a consumer fits beside the ring.
// Both dk/dv kernels mask P by kv::dead (flash_bwd_kv.cuh).
//
// Past 256 (every head dim padded to a multiple of 128 past 256): a
// consumer's dq, or dK and dV of a 64-row k block, is wider than one
// wgmma's N (256), and the D-256 plans' resident tiles no longer fit (Q and
// dO of 128 rows take 192 KB at D 384; K and V of 64 rows 160 KB at 640).
// So both kernels take the forward's plan past 256 (flash_fwd.cu): a
// block owns one panel z of the outputs' columns, [256 z, 256 z + W), W
// 256, or 128 for the last panel of an odd multiple of 128 (384 = 256 +
// 128, 640 = 256 + 256 + 128), one launch per width with the panels on
// gridDim.z; the scores take every column, streamed by TMA in 64-column
// chunks (m64n64k16 wgmma; a chunk's stage goes back once the next
// chunk's group is issued and its own read), and the output product reads
// a W-column panel MN-major from a ring of its own.  Every panel block
// streams the chunks in one order, chunk 0 first, so all the blocks of a
// tile form the same P and dS bit for bit (tools/chip_fault_check.py
// plants another order).  Each forms S and dP once per panel: at D 384
// dq does 10 D FLOP a live pair for the function's 6 and dk/dv 12 for 8.
// Bound at BH 32, S 2048, D 384, causal: 154.7 + 206.2 GFLOP, 0.1564 +
// 0.2086 ms at 989 TFLOP/s; this design's 257.8 + 309.3 GFLOP, 0.2607 +
// 0.3128 ms.
//   dq     (flash_bwd_dq_wide_kernel<T, W, CAUSAL>): one block per (bh,
//          128-row q tile, panel), longest causal rows first.  Per 64-row
//          k tile the producer streams D/64 (Q, K) chunks then D/64 (dO, V)
//          chunks (Q and dO 128 x 64, K and V 64 x 64: 24 KB a stage, six
//          stages, 144 KB), then K's W-column panel (64 x W, two stages,
//          64 KB at W 256): 208 KB.  A consumer owns 64 q rows: S and dP
//          (32 registers each), P and dS as the D-256 plan, dq_panel += dS
//          K[:, panel] (W / 2 registers), left from registers to the rows
//          below S.
//   dk/dv  (flash_bwd_dkv_wide_kernel<T, W, CAUSAL>, body
//          flash_bwd_kv.cuh's wide::kv_body, which the one-pass kernel
//          past 256 shares): one block per (bh, 64-row k block, panel),
//          kv256's split of the products: per 64-row q tile consumer 0
//          forms S^T = K Q^T over every chunk of its ring (K and Q 64 x
//          64: 16 KB a stage, four stages, 64 KB), P^T and dV_panel +=
//          P^T dO[:, panel]; consumer 1 dP^T = V dO^T over its ring (V
//          and dO, 64 KB), dS^T = P^T (dP^T - delta) and dK_panel += dS^T
//          Q[:, panel]; P^T crosses in f32 through the 16 KB exchange tile
//          under two mbarriers.  K and V are re-read chunk by chunk for
//          every q tile.  dO's and Q's W-column panels of the q tile come
//          through rings of their own (one 32 KB stage each at W 256, two
//          of 16 KB at W 128: 64 KB): 208 KB.  lse and delta are read from
//          device memory into registers; dv and dk leave in T from
//          registers to the rows below S.
//
// Left on the table: overlap inside a consumer of one tile's elementwise
// work with the next tile's products (each tile now runs products,
// softmax, products in series), ping-pong of the two consumers, a
// persistent grid (at BERT's S 384 a dq block walks three k tiles and a
// dk/dv block six q tiles), and 128-row q tiles in the dk/dv kernel; at
// D 256 the dk/dv consumer 1 waits each tile for consumer 0's P^T, which a
// second exchange tile would hide (no room for it beside the ring now);
// past 256, S and dP formed once per tile into shared memory and the
// panels walked from there, and K and V resident where they fit (up to
// 384) instead of re-read per q tile in dk/dv.
#include "flash_bwd_kv.cuh"

namespace hvdflash {

using namespace sm90;

// ----------------------------------------------------------------- dq kernel

namespace dqtile {

constexpr int BQ = 128;  // q rows per block, 64 per consumer warpgroup

// The two plans of the header.  Up to D 128: 128-row K and V tiles, a
// ring slot holding a tile's K and V, two slots, dq out through the ring.
// At D 256: 64-row tiles, a slot holding V_i or K_i (V_0, K_0, V_1, ...),
// three slots, dq out from registers.
template <typename T, int D>
struct Plan {
  static constexpr bool WIDE = D == 256;
  static constexpr int BK = WIDE ? 64 : 128;  // k rows per tile
  static constexpr int PER = WIDE ? 2 : 1;    // ring slots a k tile takes
  static constexpr int SLOTS = WIDE ? 3 : 2;
  static constexpr size_t qtile = BQ * D * sizeof(T);
  static constexpr size_t ktile = BK * D * sizeof(T);
  static constexpr size_t slot = 2 / PER * ktile;
  static constexpr size_t q = 0;             // BQ x D
  static constexpr size_t g = q + qtile;     // BQ x D
  static constexpr size_t ring = g + qtile;  // SLOTS x slot; then the dq tile
  static constexpr size_t bar = ring + SLOTS * slot;
  static constexpr size_t bytes = bar + 8 * (1 + 2 * SLOTS) + 1024;  // + alignment
  static_assert(bytes <= 232448, "a block's shared memory");
  static_assert(WIDE || BQ * D * sizeof(float) <= SLOTS * slot,
                "the f32 dq tile fits in the ring");
};

// The k tiles of BK rows that the q tile from q0 reads.  Causal liveness,
// as in the TPU kernel: k tile t is live while t*BK <= q0 + BQ - 1.
template <int BK, bool CAUSAL>
__device__ __forceinline__ int live_k_tiles(int q0, int S) {
  const int nk = (S + BK - 1) / BK;
  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  return kend;
}

// lse (in log2 units) and delta of a consumer thread's rows r0 and r0 + 8
// of head bh; a row past S reads 0, its Q and dO are zeros, so its dS is 0
// and not stored.
__device__ __forceinline__ void q_rows(float (&ls)[2], float (&dl)[2],
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta, int bh,
                                       int r0, int S) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const size_t at = (size_t)bh * S + row;
    ls[h] = row < S ? lse[at] * kv::LOG2E : 0.f;
    dl[h] = row < S ? delta[at] : 0.f;
  }
}

// dS = P (dP - delta) of rows r0, r0 + 8 against the BK k columns from k0,
// P = exp2(S log2e - lse log2e), packed to pairs of T in the accumulator's
// layout (wgmma's register A layout); the mask only where the tile
// crosses the diagonal of the consumer's rows from w0, or S.
template <typename T, int BK, bool CAUSAL>
__device__ __forceinline__ void ds_tile(uint32_t (&pds)[BK / 4], const float (&sc)[BK / 2],
                                        const float (&dp)[BK / 2], const float (&ls)[2],
                                        const float (&dl)[2], int r0, int w0, int k0,
                                        int c2, int S) {
  const bool mask = (CAUSAL && k0 + BK - 1 > w0) || k0 + BK > S;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * h + e;
        float p = exp2f(fmaf(sc[x], kv::LOG2E, -ls[h]));
        if (mask) {
          const int row = r0 + 8 * h, col = k0 + 8 * j + c2 + e;
          if (!(col < S && (!CAUSAL || col <= row))) p = 0.f;
        }
        d[e] = p * (dp[x] - dl[h]);
      }
      pds[2 * j + h] = pack<T>(d[0], d[1]);
    }
}

}  // namespace dqtile

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mg,
                    const __grid_constant__ CUtensorMap mdq,
                    float* __restrict__ dq, const float* __restrict__ lse,
                    const float* __restrict__ delta, int S) {
  using L = dqtile::Plan<T, D>;
  using PB = Panels<D>;     // (rows, D) tiles of T
  using PF = Panels<D, 4>;  // a consumer's f32 (64, D) dq tile
  constexpr int BQ = dqtile::BQ, BK = L::BK, PER = L::PER, SLOTS = L::SLOTS;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* full = qg_full + 1;
  uint64_t* empty = full + SLOTS;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int kend = dqtile::live_k_tiles<BK, CAUSAL>(q0, S);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: Q and dO once, then K and V by k tile
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(qg_full, 2 * L::qtile);
      for (int p = 0; p < PB::NP; ++p) {
        tma_load_3d(smem + L::q + p * BQ * PB::SWZ, mq, qg_full, p * PB::PC, q0, bh);
        tma_load_3d(smem + L::g + p * BQ * PB::SWZ, mg, qg_full, p * PB::PC, q0, bh);
      }
      for (int j = 0; j < PER * kend; ++j) {  // slot load j: k tile j / PER
        const int s = j % SLOTS, k0 = j / PER * BK;
        mbar_wait(&empty[s], ((j / SLOTS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], L::slot);
        unsigned char* dst = smem + L::ring + s * L::slot;
        for (int p = 0; p < PB::NP; ++p) {
          if (L::WIDE) {  // V for an even j, K for an odd one
            tma_load_3d(dst + p * BK * PB::SWZ, (j & 1) ? mk : mv, &full[s],
                        p * PB::PC, k0, bh);
          } else {
            tma_load_3d(dst + p * BK * PB::SWZ, mk, &full[s], p * PB::PC, k0, bh);
            tma_load_3d(dst + L::ktile + p * BK * PB::SWZ, mv, &full[s], p * PB::PC,
                        k0, bh);
          }
        }
      }
    }
  } else {  // consumers: q rows [q0 + 64 wg, q0 + 64 wg + 64)
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rl = 64 * wg + 16 * (t / 32) + lane / 4;  // first q row in the tile; +8
    const int c2 = 2 * (lane % 4);                      // first k column of a pair
    const unsigned char* sq = smem + L::q + 64 * wg * PB::SWZ;
    const unsigned char* sg = smem + L::g + 64 * wg * PB::SWZ;
    float ls[2], dl[2];
    dqtile::q_rows(ls, dl, lse, delta, bh, q0 + rl, S);
    float acc[D / 2];  // dq: rows rl, rl + 8 of D columns
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(qg_full, 0);
    for (int i = 0; i < kend; ++i) {
      // the slot loads of V and K (one load up to D 128)
      const int k0 = i * BK, jv = PER * i, jk = jv + PER - 1;
      mbar_wait(&full[jv % SLOTS], (jv / SLOTS) & 1);
      if (L::WIDE) mbar_wait(&full[jk % SLOTS], (jk / SLOTS) & 1);
      const unsigned char* sk = smem + L::ring + (jk % SLOTS) * L::slot;
      const unsigned char* sv =
          L::WIDE ? smem + L::ring + (jv % SLOTS) * L::slot : sk + L::ktile;

      // S = Q K^T and dP = dO V^T: rows rl, rl + 8 of BK k columns
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S, over every 64-column panel
        MmaSS<BK, 0, 0, T>::run(sc, desc_kmajor<D, BQ>(sq, kk),
                                desc_kmajor<D, BK>(sk, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP
        MmaSS<BK, 0, 0, T>::run(dp, desc_kmajor<D, BQ>(sg, kk),
                                desc_kmajor<D, BK>(sv, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (L::WIDE) mbar_arrive(&empty[jv % SLOTS]);  // V's own slot: dP is formed

      uint32_t pds[BK / 4];
      dqtile::ds_tile<T, BK, CAUSAL>(pds, sc, dp, ls, dl, q0 + rl, q0 + 64 * wg, k0, c2,
                                     S);

      // dq += dS K: A from registers, K MN-major
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pds[4 * kk], pds[4 * kk + 1], pds[4 * kk + 2],
                               pds[4 * kk + 3]};
        MmaRS<D, 1, T>::run(acc, a, desc_mnmajor<D, BK>(sk, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[jk % SLOTS]);
    }

    if constexpr (L::WIDE) {
      // Epilogue at 256: dq in f32 from registers straight to the rows
      // below S (no 64 KB f32 tile a consumer fits beside the ring).
      float* out = dq + (size_t)bh * S * D + c2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + rl + 8 * h;
        if (row < S) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(out + (size_t)row * D + 8 * j) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    } else {
      // Epilogue: dq in f32 through this consumer's half of the ring, once
      // both consumers are done with it, then one TMA store of its rows.
      named_sync(1, 256);
      unsigned char* so = smem + L::ring + wg * (64 * D * sizeof(float));
      const int qr = rl - 64 * wg;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(so + panel_offset<D, 64, 4>(qr + 8 * h, 8 * j + c2)) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      fence_proxy_async();
      named_sync(2 + wg, 128);
      if (t == 0 && q0 + 64 * wg < S) {
        for (int p = 0; p < PF::NP; ++p)
          tma_store_3d(mdq, so + p * 64 * PF::SWZ, p * PF::PC, q0 + 64 * wg, bh);
        tma_store_commit();
        tma_store_wait_read<0>();
      }
    }
  }
}

template <typename T, int D, bool CAUSAL>
static cudaError_t launch_dq(const T* q, const T* k, const T* v, const T* g,
                             const float* lse, const float* delta, float* dq,
                             int bh, int s, cudaStream_t stream) {
  using L = dqtile::Plan<T, D>;
  CUtensorMap mq, mk, mv, mg, mdq{};  // at 256 dq leaves without a map
  cudaError_t err;
  if ((err = panel_map<D>(&mq, q, s, bh, dqtile::BQ)) != cudaSuccess ||
      (err = panel_map<D>(&mg, g, s, bh, dqtile::BQ)) != cudaSuccess ||
      (err = panel_map<D>(&mk, k, s, bh, L::BK)) != cudaSuccess ||
      (err = panel_map<D>(&mv, v, s, bh, L::BK)) != cudaSuccess)
    return err;
  if constexpr (!L::WIDE)
    if ((err = panel_map<D>(&mdq, dq, s, bh, 64)) != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_kernel<T, D, CAUSAL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + dqtile::BQ - 1) / dqtile::BQ);
  kernel<<<grid, 384, L::bytes, stream>>>(mq, mk, mv, mg, mdq, dq, lse, delta, s);
  return cudaGetLastError();
}

// --------------------------------------------------------------- dkv kernel

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mg,
                     const __grid_constant__ CUtensorMap mlse,
                     const __grid_constant__ CUtensorMap mdelta,
                     const __grid_constant__ CUtensorMap mdk,
                     const __grid_constant__ CUtensorMap mdv, int S) {
  // no partials: the body reads neither its dq map (mdk stands in) nor dqp
  kv::ktile_body<T, D, CAUSAL, false>(mq, mk, mv, mg, mlse, mdelta, mdk, mdk,
                                      mdv, nullptr, S);
}

template <typename T, int D, bool CAUSAL>
static cudaError_t launch_dkv(const T* q, const T* k, const T* v, const T* g,
                              const float* lse, const float* delta, T* dk, T* dv,
                              int bh, int s, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg, mlse, mdelta, mdk, mdv;
  cudaError_t err = kv::ktile_maps<T, D>(&mq, &mk, &mv, &mg, &mlse, &mdelta, &mdk,
                                         &mdv, q, k, v, g, lse, delta, dk, dv, bh, s);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_kernel<T, D, CAUSAL>;
  const size_t bytes = kv::Smem<T, D, false>::bytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + kv::BK - 1) / kv::BK);
  kernel<<<grid, 384, bytes, stream>>>(mq, mk, mv, mg, mlse, mdelta, mdk, mdv, s);
  return cudaGetLastError();
}

// ---------------------------------------------------- dkv kernel at D 256

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_d256_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mg,
                          const __grid_constant__ CUtensorMap mlse,
                          const __grid_constant__ CUtensorMap mdelta,
                          const __grid_constant__ CUtensorMap mdk,
                          const __grid_constant__ CUtensorMap mdv, int S) {
  static_assert(D == 256, "the D 256 plan");
  // no partials: the body does not read dqp
  kv256::kblock_body<T, CAUSAL, false>(mq, mk, mv, mg, mlse, mdelta, mdk, mdv,
                                       nullptr, S);
}

template <typename T, bool CAUSAL>
static cudaError_t launch_dkv_d256(const T* q, const T* k, const T* v, const T* g,
                                   const float* lse, const float* delta, T* dk,
                                   T* dv, int bh, int s, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg, mlse, mdelta, mdk, mdv;
  cudaError_t err = kv::ktile_maps<T, 256>(&mq, &mk, &mv, &mg, &mlse, &mdelta, &mdk,
                                           &mdv, q, k, v, g, lse, delta, dk, dv, bh,
                                           s, kv256::BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_d256_kernel<T, 256, CAUSAL>;
  const size_t bytes = kv256::Smem<T, false>::bytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + kv256::BK - 1) / kv256::BK);
  kernel<<<grid, 384, bytes, stream>>>(mq, mk, mv, mg, mlse, mdelta, mdk, mdv, s);
  return cudaGetLastError();
}

// dk/dv by width: at 256 the plan above, up to 128 the k-tile body.
template <typename T, int D, bool CAUSAL>
static cudaError_t run_dkv(const T* q, const T* k, const T* v, const T* g,
                           const float* lse, const float* delta, T* dk, T* dv,
                           int bh, int s, cudaStream_t stream) {
  if constexpr (D == 256)
    return launch_dkv_d256<T, CAUSAL>(q, k, v, g, lse, delta, dk, dv, bh, s, stream);
  else
    return launch_dkv<T, D, CAUSAL>(q, k, v, g, lse, delta, dk, dv, bh, s, stream);
}

// ---------------------------------------------------------- past 256

namespace wide {

// dq: 128-row q tiles, SA stages of (Q or dO chunk 128 x 64, K or V chunk
// 64 x 64), two stages of K's W-column panel.
namespace dq {
constexpr int BQ = dqtile::BQ, SA = 6, KS = 2;
template <typename T, int W>
struct Smem {
  static constexpr size_t qc = BQ * CW * sizeof(T);          // 16 KB
  static constexpr size_t chunk = qc + BK * CW * sizeof(T);  // 24 KB
  static constexpr size_t kp = BK * W * sizeof(T);           // 32 or 16 KB
  static constexpr size_t k = SA * chunk;                    // KS x kp after the ring
  static constexpr size_t bar = k + KS * kp;
  static constexpr size_t bytes = bar + 8 * 2 * (SA + KS) + 1024;  // + alignment
  static_assert(bytes <= 232448, "a block's shared memory");
};
}  // namespace dq

}  // namespace wide

template <typename T, int W, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mg,
                         float* __restrict__ dq, const float* __restrict__ lse,
                         const float* __restrict__ delta, int S, int DW, int z0) {
  using L = wide::dq::Smem<T, W>;
  constexpr int BQ = wide::dq::BQ, BK = wide::BK, CW = wide::CW;
  constexpr int SA = wide::dq::SA, KS = wide::dq::KS;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* cfull = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* cempty = cfull + SA;
  uint64_t* kfull = cempty + SA;
  uint64_t* kempty = kfull + KS;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int z = z0 + blockIdx.z;  // dq's columns [256 z, 256 z + W)
  const int nc = DW / CW;
  const int kend = dqtile::live_k_tiles<BK, CAUSAL>(q0, S);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(&cfull[s], 1);
      mbar_init(&cempty[s], 256);  // every consumer thread
    }
    for (int s = 0; s < KS; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: per k tile nc (Q, K) chunks, nc (dO, V), K's panel
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int n = 0;  // chunks requested
      for (int i = 0; i < kend; ++i) {
        const int k0 = i * BK;
        for (int c = 0; c < 2 * nc; ++c, ++n) {
          // one chunk order in every panel block: chunk 0 first
          const int s = n % SA, col = CW * (c % nc);
          mbar_wait(&cempty[s], ((n / SA) & 1) ^ 1);
          mbar_arrive_expect_tx(&cfull[s], L::chunk);
          unsigned char* sc = smem + s * L::chunk;
          tma_load_3d(sc, c < nc ? mq : mg, &cfull[s], col, q0, bh);
          tma_load_3d(sc + L::qc, c < nc ? mk : mv, &cfull[s], col, k0, bh);
        }
        const int s = i % KS;
        mbar_wait(&kempty[s], ((i / KS) & 1) ^ 1);
        mbar_arrive_expect_tx(&kfull[s], L::kp);
        unsigned char* sk = smem + L::k + s * L::kp;
        for (int p = 0; p < W / CW; ++p)
          tma_load_3d(sk + p * BK * 128, mk, &kfull[s], 256 * z + CW * p, k0, bh);
      }
    }
  } else {  // consumers: q rows [q0 + 64 wg, q0 + 64 wg + 64), dq's panel z
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rl = 64 * wg + 16 * (t / 32) + lane / 4;  // first q row in the tile; +8
    const int c2 = 2 * (lane % 4);                      // first k column of a pair
    float ls[2], dl[2];
    dqtile::q_rows(ls, dl, lse, delta, bh, q0 + rl, S);
    float acc[W / 2];  // dq: rows rl, rl + 8 of the panel's W columns
#pragma unroll
    for (int x = 0; x < W / 2; ++x) acc[x] = 0.f;

    int n = 0;  // chunks consumed
    for (int i = 0; i < kend; ++i) {
      const int k0 = i * BK;
      // S = Q K^T, then dP = dO V^T, each summed chunk by chunk over every
      // column; a chunk's stage goes back once the next chunk's group is
      // issued and its own has been read
      float sc[BK / 2], dp[BK / 2];
      for (int c = 0; c < 2 * nc; ++c, ++n) {
        const int s = n % SA;
        mbar_wait(&cfull[s], (n / SA) & 1);
        const unsigned char* sa = smem + s * L::chunk + 64 * wg * 128;
        const unsigned char* sb = smem + s * L::chunk + L::qc;
        if (c < nc)
          wide::chunk_mma<T>(sc, sa, sb, c > 0);
        else
          wide::chunk_mma<T>(dp, sa, sb, c > nc);
        if (c > 0) {
          wgmma_wait<1>();
          mbar_arrive(&cempty[(n - 1) % SA]);
        }
      }
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(&cempty[(n - 1) % SA]);

      uint32_t pds[BK / 4];
      dqtile::ds_tile<T, BK, CAUSAL>(pds, sc, dp, ls, dl, q0 + rl, q0 + 64 * wg, k0, c2,
                                     S);

      // dq += dS K[:, panel]: K's W-column panel read MN-major
      const int s = i % KS;
      mbar_wait(&kfull[s], (i / KS) & 1);
      wide::panel_mma<T, W>(acc, pds, smem + L::k + s * L::kp);
      mbar_arrive(&kempty[s]);
    }

    // Epilogue: dq in f32 from registers straight to the panel's columns
    // of the rows below S.
    float* out = dq + (size_t)bh * S * DW + 256 * z + c2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rl + 8 * h;
      if (row < S) {
#pragma unroll
        for (int j = 0; j < W / 8; ++j)
          *reinterpret_cast<float2*>(out + (size_t)row * DW + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <typename T, int W, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mg,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int S, int DW, int z0) {
  // no partials: the body does not read dqp
  wide::kv_body<T, W, CAUSAL, false>(mq, mk, mv, mg, lse, delta, dk, dv, nullptr, S, DW,
                                     z0);
}

// One launch of panels [z0, z0 + nz) of W columns each.
template <typename T, int W, bool CAUSAL>
static cudaError_t launch_dq_panels(const CUtensorMap& mq, const CUtensorMap& mk,
                                    const CUtensorMap& mv, const CUtensorMap& mg,
                                    const float* lse, const float* delta, float* dq,
                                    int bh, int s, int d, int z0, int nz,
                                    cudaStream_t stream) {
  const size_t bytes = wide::dq::Smem<T, W>::bytes;
  auto kernel = flash_bwd_dq_wide_kernel<T, W, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + wide::dq::BQ - 1) / wide::dq::BQ, nz);
  kernel<<<grid, 384, bytes, stream>>>(mq, mk, mv, mg, dq, lse, delta, s, d, z0);
  return cudaGetLastError();
}

template <typename T, int W, bool CAUSAL>
static cudaError_t launch_dkv_panels(const CUtensorMap& mq, const CUtensorMap& mk,
                                     const CUtensorMap& mv, const CUtensorMap& mg,
                                     const float* lse, const float* delta, T* dk, T* dv,
                                     int bh, int s, int d, int z0, int nz,
                                     cudaStream_t stream) {
  const size_t bytes = wide::dkv::Smem<T, W, false>::bytes;
  auto kernel = flash_bwd_dkv_wide_kernel<T, W, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + wide::BK - 1) / wide::BK, nz);
  kernel<<<grid, 384, bytes, stream>>>(mq, mk, mv, mg, lse, delta, dk, dv, s, d, z0);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
static cudaError_t launch_dq_wide(const T* q, const T* k, const T* v, const T* g,
                                  const float* lse, const float* delta, float* dq,
                                  int bh, int s, int d, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg;
  cudaError_t err = wide::chunk_maps<T>(&mq, &mk, &mv, &mg, q, k, v, g, bh, s, d,
                                        wide::dq::BQ);
  if (err != cudaSuccess) return err;
  return wide::by_panels(
      d,
      [&](int z0, int nz) {
        return launch_dq_panels<T, 256, CAUSAL>(mq, mk, mv, mg, lse, delta, dq, bh, s,
                                                d, z0, nz, stream);
      },
      [&](int z0, int nz) {
        return launch_dq_panels<T, 128, CAUSAL>(mq, mk, mv, mg, lse, delta, dq, bh, s,
                                                d, z0, nz, stream);
      });
}

template <typename T, bool CAUSAL>
static cudaError_t launch_dkv_wide(const T* q, const T* k, const T* v, const T* g,
                                   const float* lse, const float* delta, T* dk, T* dv,
                                   int bh, int s, int d, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg;
  cudaError_t err = wide::chunk_maps<T>(&mq, &mk, &mv, &mg, q, k, v, g, bh, s, d,
                                        wide::dkv::BQ);
  if (err != cudaSuccess) return err;
  return wide::by_panels(
      d,
      [&](int z0, int nz) {
        return launch_dkv_panels<T, 256, CAUSAL>(mq, mk, mv, mg, lse, delta, dk, dv, bh,
                                                 s, d, z0, nz, stream);
      },
      [&](int z0, int nz) {
        return launch_dkv_panels<T, 128, CAUSAL>(mq, mk, mv, mg, lse, delta, dk, dv, bh,
                                                 s, d, z0, nz, stream);
      });
}

}  // namespace hvdflash

// dtype: 1 float16, 2 bfloat16 (the codes of flash_simt.cu).  d: 32, 64,
// 128, 256, or a multiple of 128 past 256.  Each returns a cudaError_t
// (cudaErrorInvalidValue for a dtype or d it does not take).
#define HVD_BWD_WIDTHS(CASE, WIDE, T)           \
  switch (d) {                                  \
    CASE(T, 32)                                 \
    CASE(T, 64)                                 \
    CASE(T, 128)                                \
    CASE(T, 256)                                \
    default:                                    \
      if (d > 256 && d % 128 == 0) WIDE(T)      \
      return (int)cudaErrorInvalidValue;        \
  }

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* g, const void* lse, const void* delta,
                                void* dq, int bh, int s, int d, int causal,
                                int dtype, void* stream) {
  using namespace hvdflash;
  auto st = static_cast<cudaStream_t>(stream);
  auto LSE = static_cast<const float*>(lse);
  auto DEL = static_cast<const float*>(delta);
  auto DQ = static_cast<float*>(dq);
#define HVD_DQ(T, DD)                                                        \
  case DD: {                                                                 \
    auto Q = static_cast<const T*>(q);                                       \
    auto K = static_cast<const T*>(k);                                       \
    auto V = static_cast<const T*>(v);                                       \
    auto G = static_cast<const T*>(g);                                       \
    return causal ? launch_dq<T, DD, true>(Q, K, V, G, LSE, DEL, DQ, bh, s, st)  \
                  : launch_dq<T, DD, false>(Q, K, V, G, LSE, DEL, DQ, bh, s, st); \
  }
#define HVD_DQ_WIDE(T)                                                        \
  {                                                                           \
    auto Q = static_cast<const T*>(q);                                        \
    auto K = static_cast<const T*>(k);                                        \
    auto V = static_cast<const T*>(v);                                        \
    auto G = static_cast<const T*>(g);                                        \
    return causal ? launch_dq_wide<T, true>(Q, K, V, G, LSE, DEL, DQ, bh, s, d, st)  \
                  : launch_dq_wide<T, false>(Q, K, V, G, LSE, DEL, DQ, bh, s, d, st); \
  }
  if (dtype == 1) HVD_BWD_WIDTHS(HVD_DQ, HVD_DQ_WIDE, __half)
  if (dtype == 2) HVD_BWD_WIDTHS(HVD_DQ, HVD_DQ_WIDE, __nv_bfloat16)
  return (int)cudaErrorInvalidValue;
#undef HVD_DQ_WIDE
#undef HVD_DQ
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int s, int d,
                                 int causal, int dtype, void* stream) {
  using namespace hvdflash;
  auto st = static_cast<cudaStream_t>(stream);
  auto LSE = static_cast<const float*>(lse);
  auto DEL = static_cast<const float*>(delta);
#define HVD_DKV(T, DD)                                                        \
  case DD: {                                                                  \
    auto Q = static_cast<const T*>(q);                                        \
    auto K = static_cast<const T*>(k);                                        \
    auto V = static_cast<const T*>(v);                                        \
    auto G = static_cast<const T*>(g);                                        \
    auto DK = static_cast<T*>(dk);                                            \
    auto DV = static_cast<T*>(dv);                                            \
    return causal                                                             \
        ? run_dkv<T, DD, true>(Q, K, V, G, LSE, DEL, DK, DV, bh, s, st)       \
        : run_dkv<T, DD, false>(Q, K, V, G, LSE, DEL, DK, DV, bh, s, st);     \
  }
#define HVD_DKV_WIDE(T)                                                        \
  {                                                                            \
    auto Q = static_cast<const T*>(q);                                         \
    auto K = static_cast<const T*>(k);                                         \
    auto V = static_cast<const T*>(v);                                         \
    auto G = static_cast<const T*>(g);                                         \
    auto DK = static_cast<T*>(dk);                                             \
    auto DV = static_cast<T*>(dv);                                             \
    return causal                                                              \
        ? launch_dkv_wide<T, true>(Q, K, V, G, LSE, DEL, DK, DV, bh, s, d, st)   \
        : launch_dkv_wide<T, false>(Q, K, V, G, LSE, DEL, DK, DV, bh, s, d, st); \
  }
  if (dtype == 1) HVD_BWD_WIDTHS(HVD_DKV, HVD_DKV_WIDE, __half)
  if (dtype == 2) HVD_BWD_WIDTHS(HVD_DKV, HVD_DKV_WIDE, __nv_bfloat16)
  return (int)cudaErrorInvalidValue;
#undef HVD_DKV_WIDE
#undef HVD_DKV
}
#undef HVD_BWD_WIDTHS
