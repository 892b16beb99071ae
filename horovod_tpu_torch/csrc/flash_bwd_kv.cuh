// The body of the flash-attention backward kernels that own a k tile:
// flash_bwd.cu's dk/dv kernel and flash_bwd_onepass.cu's one-pass kernel,
// which adds the f32 dq partials (PARTIALS).  Same function as the TPU's
// _flash_bwd_dkv_kernel and _flash_bwd_onepass_kernel, q pre-scaled by
// 1/sqrt(D):
//   p  = exp(q k^T - lse), 0 where masked
//   ds = p * (g v^T - delta)            (delta = rowsum(g * o), from the caller)
//   dv = p^T g     (p cast to g's dtype), summed over the q tiles in f32
//   dk = ds^T q    (ds cast to q's dtype), likewise
//   with PARTIALS: dqp[bh, t] = ds[:, k tile t] k[k tile t]  (ds cast to
//   k's dtype, f32 out), one (S, D) slot per 128-row k tile.
//
// Design: the TPU kernels kept this k tile's dk and dv in VMEM scratch
// across the sequential q axis of their grid.  Here one block owns a (bh,
// 128-row k tile) and loops over the live 64-row q tiles.  Three
// warpgroups: a producer that gives up registers and starts TMA loads
// from one thread (K and V once; Q, dO and the tile's values of lse and
// delta through a ring of two stages, each with a "full" and an
// "empty" mbarrier), and two consumers of 64 k rows each.  Per q tile a
// consumer computes S^T = K Q^T and dP^T = V dO^T by wgmma from shared
// memory into f32 registers, P^T = exp2(S^T log2e - lse log2e) and dS^T =
// P^T (dP^T - delta) on those registers (masked only where the tile
// crosses the diagonal or the ragged end), and adds dV += P^T dO and dK +=
// dS^T Q by wgmma with A from registers (P and dS packed to T in the
// accumulator's layout) and dO, Q read MN-major; dk and dv stay in
// registers for the whole loop.  T, the inputs' and dk's and dv's type,
// is bf16 or f16 (both kernels take both): the products take T with f32
// accumulation, P and dS are packed to T.
//
// With PARTIALS, dS^T also goes to shared memory as T, and the dq
// partial dS K is one more wgmma, A (dS) and B (K) both MN-major, its D
// columns split between the two consumers.  Each consumer's f32 half of
// the partial goes through a double-buffered swizzled tile and a TMA
// store into its slot while the next q tile computes; a store must have
// read its buffer (cp.async.bulk.wait_group.read) before the buffer is
// written again, and the epilogue reuses the buffers for dk and dv.
// Without partials a consumer reads only its own 64 rows of K and V, so
// its epilogue writes dk and dv over them, with no buffers and no wait on
// the other consumer.
//
// 3-D tensor maps, (D, S, BH) and (D, S, BH nk), read zeros past S and
// store nothing there.  Every block writes only its own rows: no atomics,
// and the outputs repeat bit for bit.
#pragma once

#include "sm90.cuh"

namespace hvdflash {
namespace kv {

using namespace sm90;

constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 128;  // k rows per block (and per dq partial), 64 per consumer
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
// lse and delta come as boxes of (BH S) vectors that start on a 16-byte
// boundary, as TMA requires: 4 more values than a q tile, from the
// tile's first row rounded down to a multiple of 4.
constexpr int ROWS_BOX = BQ + 4;
constexpr int ROWS_STRIDE = 128;  // floats between boxes in shared memory

template <typename T, int D, bool PARTIALS>
struct Smem {
  static constexpr size_t qtile = BQ * D * sizeof(T);
  static constexpr size_t k = 0;                           // BK x D
  static constexpr size_t v = k + BK * D * sizeof(T);      // BK x D
  static constexpr size_t ring = v + BK * D * sizeof(T);   // STAGES x (Q, dO)
  static constexpr size_t ds = ring + STAGES * 2 * qtile;  // dS^T, BK x BQ of T
  static constexpr size_t out =                            // 2 x (BQ x D f32)
      ds + (PARTIALS ? BK * BQ * sizeof(T) : 0);
  static constexpr size_t out_buf = BQ * D * sizeof(float);
  static constexpr size_t rows =                           // STAGES x (lse, delta)
      out + (PARTIALS ? 2 * out_buf : 0);
  static constexpr size_t bar = rows + STAGES * 2 * ROWS_STRIDE * sizeof(float);
  static constexpr size_t bytes = bar + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
  // the epilogue's dv and dk tiles (BK x D of T each) fill the out buffers
  static_assert(2 * out_buf == 2 * BK * D * sizeof(T), "dk/dv tiles");
};

// Whether P of q row q and k row k is masked to 0: a row at or past S,
// or, causal, k after q.  The dk/dv kernels (this body's, and
// flash_bwd.cu's at D 256) ask it only on a tile that crosses the
// diagonal or S, so that the other tiles skip the index work.
template <bool CAUSAL>
__device__ __forceinline__ bool dead(int q, int k, int S) {
  return !(q < S && k < S && (!CAUSAL || k <= q));
}

// The block of k tile blockIdx.y of head blockIdx.x (gridDim.y = nk).
// Without PARTIALS, mdqp and dqp are not read.
template <typename T, int D, bool CAUSAL, bool PARTIALS>
__device__ __forceinline__ void ktile_body(
    const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
    const CUtensorMap& mg, const CUtensorMap& mlse, const CUtensorMap& mdelta,
    const CUtensorMap& mdqp, const CUtensorMap& mdk, const CUtensorMap& mdv,
    float* __restrict__ dqp, int S) {
  using L = Smem<T, D, PARTIALS>;
  using PB = Panels<D>;       // (rows, D) tiles of T
  using PF = Panels<D / 2, 4>;  // one consumer's f32 half of a partial tile
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  float* srows = reinterpret_cast<float*>(smem + L::rows);

  const int bh = blockIdx.x, kt = blockIdx.y, nk = gridDim.y, k0 = kt * BK;
  const int nq = (S + BQ - 1) / BQ;
  // q tiles before qstart lie wholly above the causal diagonal of this k
  // tile: their rows of the slot are zero (all of them < k0 <= S).
  const int qstart = CAUSAL ? k0 / BQ : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
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
      mbar_arrive_expect_tx(kv_full, 2 * BK * D * sizeof(T));
      for (int p = 0; p < PB::NP; ++p) {
        tma_load_3d(smem + L::k + p * BK * PB::SWZ, mk, kv_full, p * PB::PC, k0, bh);
        tma_load_3d(smem + L::v + p * BK * PB::SWZ, mv, kv_full, p * PB::PC, k0, bh);
      }
      for (int i = 0; i < nq - qstart; ++i) {
        const int s = i % STAGES, q0 = (qstart + i) * BQ;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::qtile + 2 * ROWS_BOX * sizeof(float));
        unsigned char* sq = smem + L::ring + s * 2 * L::qtile;
        for (int p = 0; p < PB::NP; ++p) {
          tma_load_3d(sq + p * BQ * PB::SWZ, mq, &full[s], p * PB::PC, q0, bh);
          tma_load_3d(sq + L::qtile + p * BQ * PB::SWZ, mg, &full[s], p * PB::PC,
                      q0, bh);
        }
        // lse and delta as (BH S) vectors: rows past S read the next
        // head's values (or zeros at the end), which the mask drops.
        const int r0 = (bh * S + q0) & ~3;
        tma_load_1d(srows + s * 2 * ROWS_STRIDE, mlse, &full[s], r0);
        tma_load_1d(srows + s * 2 * ROWS_STRIDE + ROWS_STRIDE, mdelta, &full[s], r0);
      }
    }
  } else {  // consumers: k rows [k0 + 64 wg, k0 + 64 wg + 64)
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rl = 64 * wg + 16 * (t / 32) + lane / 4;  // first k row in the tile; +8
    const int c2 = 2 * (lane % 4);                      // first q column of a pair
    unsigned char* sk = smem + L::k;
    unsigned char* sv = smem + L::v;
    unsigned char* sds = smem + L::ds;
    const size_t slot_row0 = ((size_t)bh * nk + kt) * S;  // this tile's slot, in rows

    if constexpr (PARTIALS) {
      for (size_t i = t + 128 * wg; i < (size_t)qstart * BQ * D / 4; i += 256)
        reinterpret_cast<float4*>(dqp + slot_row0 * D)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    float dv[D / 2], dk[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < nq - qstart; ++i) {
      const int s = i % STAGES, q0 = (qstart + i) * BQ;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* sq = smem + L::ring + s * 2 * L::qtile;
      const unsigned char* sg = sq + L::qtile;
      const float* slse = srows + s * 2 * ROWS_STRIDE + ((bh * S + q0) & 3);
      const float* sdelta = slse + ROWS_STRIDE;

      // S^T = K Q^T and dP^T = V dO^T: rows rl, rl + 8 (k) of 64 q columns
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        MmaSS<BQ, 0, 0, T>::run(st, desc_kmajor<D, BK>(sk + 64 * wg * PB::SWZ, kk),
                             desc_kmajor<D, BQ>(sq, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        MmaSS<BQ, 0, 0, T>::run(dpt, desc_kmajor<D, BK>(sv + 64 * wg * PB::SWZ, kk),
                             desc_kmajor<D, BQ>(sg, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T, packed to pairs of T in the accumulator's layout
      const bool mask = (CAUSAL && q0 < k0 + 64 * wg + 63) || q0 + BQ > S ||
                        k0 + 64 * wg + 64 > S;
      uint32_t pp[BQ / 4], pds[BQ / 4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 ls = make_float2(slse[8 * j + c2], slse[8 * j + c2 + 1]);
        const float2 dl = make_float2(sdelta[8 * j + c2], sdelta[8 * j + c2 + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[2], d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * h + e;
            p[e] = exp2f(fmaf(st[x], LOG2E, -(e ? ls.y : ls.x) * LOG2E));
            if (mask && dead<CAUSAL>(q0 + 8 * j + c2 + e, k0 + rl + 8 * h, S))
              p[e] = 0.f;
            d[e] = p[e] * (dpt[x] - (e ? dl.y : dl.x));
          }
          pp[2 * j + h] = pack<T>(p[0], p[1]);
          pds[2 * j + h] = pack<T>(d[0], d[1]);
        }
      }

      // dV += P^T dO and dK += dS^T Q, A from registers, B MN-major
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2], pp[4 * kk + 3]};
        MmaRS<D, 1, T>::run(dv, a, desc_mnmajor<D, BQ>(sg, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {pds[4 * kk], pds[4 * kk + 1], pds[4 * kk + 2],
                               pds[4 * kk + 3]};
        MmaRS<D, 1, T>::run(dk, a, desc_mnmajor<D, BQ>(sq, kk), 1);
      }
      wgmma_commit();

      if constexpr (!PARTIALS) {
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        mbar_arrive(&empty[s]);
      } else {
        // dS^T to shared memory, once the other consumer's previous dq
        // product has read it
        named_sync(1, 256);
#pragma unroll
        for (int x = 0; x < BQ / 4; ++x)
          *reinterpret_cast<uint32_t*>(
              sds + panel_offset<BQ, BK>(rl + 8 * (x % 2), 8 * (x / 2) + c2)) = pds[x];
        fence_proxy_async();
        // this consumer's out buffer is free once its store of two q
        // tiles ago has read it
        if (t == 0) tma_store_wait_read<1>();
        named_sync(1, 256);

        // dq partial, columns [wg D/2, wg D/2 + D/2): dS (64 x 128) K (128 x D/2)
        float dq[D / 4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          MmaSS<D / 2, 1, 1, T>::run(dq, desc_mnmajor<BQ, BK>(sds, kk),
                                  desc_mnmajor<D, BK>(sk, kk, wg * (D / 2)), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(dq);
        mbar_arrive(&empty[s]);

        unsigned char* so = smem + L::out + (i % 2) * L::out_buf + wg * (L::out_buf / 2);
        const int qr = 16 * (t / 32) + lane / 4;  // q row of dq[4 j], dq[4 j + 1]; +8
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(so + panel_offset<D / 2, BQ, 4>(qr + 8 * h, 8 * j + c2)) =
                make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
        fence_proxy_async();
        named_sync(2 + wg, 128);
        if (t == 0) {
          for (int p = 0; p < PF::NP; ++p)
            tma_store_3d(mdqp, so + p * BQ * PF::SWZ, wg * (D / 2) + p * PF::PC, q0,
                         bh * nk + kt);
          tma_store_commit();
        }
      }
    }

    // Epilogue: dv and dk in T.  With partials through the out
    // buffers, once both consumers' partial stores have read them; without,
    // over this consumer's own rows of V and K, which only it reads.
    unsigned char* sdv = sv;
    unsigned char* sdk = sk;
    if constexpr (PARTIALS) {
      if (t == 0) tma_store_wait_read<0>();
      named_sync(1, 256);
      sdv = smem + L::out;
      sdk = sdv + BK * D * sizeof(T);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = panel_offset<D, BK>(rl + 8 * h, 8 * j + c2);
        *reinterpret_cast<uint32_t*>(sdv + off) =
            pack<T>(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(sdk + off) =
            pack<T>(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
      }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (t == 0 && k0 + 64 * wg < S) {
      for (int p = 0; p < PB::NP; ++p) {
        const size_t off = p * BK * PB::SWZ + 64 * wg * PB::SWZ;
        tma_store_3d(mdv, sdv + off, p * PB::PC, k0 + 64 * wg, bh);
        tma_store_3d(mdk, sdk + off, p * PB::PC, k0 + 64 * wg, bh);
      }
      tma_store_commit();
      tma_store_wait_read<0>();
    }
  }
}

// The tensor maps of the inputs and of dk, dv: (D, S, BH) tiles of T and
// the (BH S) lse and delta vectors.  K and V load as boxes of `kbox` rows
// (the block's k rows: BK here, 64 in flash_bwd.cu's D 256 kernel).
template <typename T, int D>
inline cudaError_t ktile_maps(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv,
                              CUtensorMap* mg, CUtensorMap* mlse,
                              CUtensorMap* mdelta, CUtensorMap* mdk,
                              CUtensorMap* mdv, const T* q, const T* k,
                              const T* v, const T* g, const float* lse,
                              const float* delta, T* dk, T* dv, int bh,
                              int s, uint32_t kbox = BK) {
  const uint64_t rows_dim[1] = {(uint64_t)bh * s};
  const uint32_t rows_box[1] = {ROWS_BOX};
  cudaError_t err;
  if ((err = panel_map<D>(mq, q, s, bh, BQ)) != cudaSuccess ||
      (err = panel_map<D>(mg, g, s, bh, BQ)) != cudaSuccess ||
      (err = panel_map<D>(mk, k, s, bh, kbox)) != cudaSuccess ||
      (err = panel_map<D>(mv, v, s, bh, kbox)) != cudaSuccess ||
      (err = panel_map<D>(mdk, (const T*)dk, s, bh, 64)) != cudaSuccess ||
      (err = panel_map<D>(mdv, (const T*)dv, s, bh, 64)) != cudaSuccess ||
      (err = encode_map(mlse, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, lse, rows_dim,
                        nullptr, rows_box, CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess)
    return err;
  return encode_map(mdelta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, delta, rows_dim,
                    nullptr, rows_box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace kv
}  // namespace hvdflash
