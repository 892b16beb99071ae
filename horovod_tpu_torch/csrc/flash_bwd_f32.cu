// Flash-attention dq and dk/dv for Hopper (sm_90a) in float32, at head
// dims 32, 64, 128, 256 and every multiple of 128 past 256: the scores and
// the three output products on the tensor cores as split TF32, dP on the
// CUDA cores in the plain version's order.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel, launched by _flash_attention_bwd_flat, at f32
// inputs.  Same function as flash_bwd_reference in f32, q pre-scaled by
// 1/sqrt(D):
//   p  = exp(q k^T - lse), 0 where masked (causal, or a key past S)
//   ds = p * (g v^T - delta)            (delta = rowsum(g * o), from the caller)
//   dq = ds k, dk = ds^T q, dv = p^T g  (all f32; dq in q's pre-scaled units)
// Under f32 every cast of the TPU kernels is the identity.  Tiles wholly
// above the diagonal are skipped; the mask is applied only where a tile
// crosses the diagonal or S.
//
// Bound on the H100 SXM: operations.  One pass of products at width D over
// the live (q, k) pairs is 2 D pairs FLOP; dq takes three (S, dP, dS K),
// dk/dv four (S^T, dP^T, P^T dO, dS^T Q).  As split TF32 (three TF32
// products an f32 one at 495 TFLOP/s: 165 TFLOP/s of f32), at BH 32, S
// 2048, causal, and at BERT-Large's shape (BH 512, S 384, D 64, full):
//             D 128    BERT     D 256   D 384
//   dq, ms    0.3125   0.1757   0.625   0.9375
//   dk/dv, ms 0.4167   0.2343   0.8333  1.250
// (0.406 of the time of the same products on the CUDA cores at 67
// TFLOP/s.)  This design forms dP on the CUDA cores (below): its own floor
// at D 128 is 0.2083 + 0.2566 ms for dq and 0.3125 + 0.2566 for dk/dv.
//
// dP on the CUDA cores.  dS = P (dP - delta) cancels where one key holds
// nearly all of a row's weight (a causal row 0 exactly: delta = dP there,
// so dS is the rounding of both), and there dq is rounding noise whose
// size depends on the order dP was summed in.  The f32 limits (2^-16,
// 2^-16 of the row's scale, floored at 1/16 of the tensor's RMS) hold that
// noise to the plain version's own.  A torch emulation of these kernels
// on an H100 (tools/chip_simt_probe.py --f32-bwd, running
// tests/test_torch_port_hopper_f32_bwd.py's) read dq at BH 4096, S 64, D
// 32 and at BH 32, S 2048, D 128, causal: 39.56 and 50.56 of the limits
// with dP in split TF32 in 32-column chains, 9.056 and 28.55 with a
// correctly rounded f32 dP, 0.418 and 0.546 with dP summed as the plain
// version sums it (one f32 fma chain per element over D in order, as an
// f32 matrix product on the card and the CUDA-core twins in flash_simt.cu
// sum it).  So each consumer thread forms 32 dP elements as fma chains
// from 32-column chunks of dO and V in shared memory, the chunks in order,
// and the kernels are held to the f32 plain version, whose dP they
// reproduce (not to exact_dp's f64 one).  A lane forms 4 rows by 8 keys
// of its warp's 16 x 64 (4 + 8 loads of 16 bytes per 4 columns of D, where
// the accumulator's 2 rows by 16 keys would take 2 + 16) and warp shuffles
// then move them into the accumulator's layout (timed against the
// accumulator's layout in PERF.md).
//
// Split TF32 (tf32.cuh).  Trap 1: TF32 wgmma takes both operands K-major
// only.  S = Q K^T (dq) and S^T = K Q^T (dk/dv) contract over D: both
// operands K-major as stored.  dS K contracts over keys, so its B is K^T
// with keys contiguous; P^T dO and dS^T Q contract over q rows, so theirs
// are dO^T and Q^T with q rows contiguous.  The wrappers pass those copies
// (ops/flash_attention.py f32_vt: (BH, D, S8), zero-padded to a multiple of
// 8; their time is the call's, about 0.06 ms each at D 384), as the forward
// passes V^T: a transpose in shared memory by the producer's warps would
// keep them out of device memory but needs a second layout per tile, and
// a copy costs a few percent of these kernels' time.  Trap 2: a TF32 A
// fragment wants columns c and c + 4 where an accumulator gives a thread
// 2c and 2c + 1, so f32_vt stores each group of 8 keys (or q rows) in the
// order 0, 2, 4, 6, 1, 3, 5, 7 and P, dS, P^T and dS^T go from their
// accumulator registers into the next product with no shuffle.  Trap 3:
// the tensor core truncates each sum into its accumulator, so S (S^T) is
// summed per 32-column chunk (12 products), and dS K, P^T dO and dS^T Q
// per 64 keys or q rows (24 products), each in a fresh accumulator then
// added to its running sum in f32.
//
// dq (flash_bwd_dq_f32): a block owns (bh, 128-row q tile, panel z of dq's
// columns, W = D up to 128, else 128).  Three warpgroups, as the forward's:
// the producer's thread 0 starts TMA loads, per 64-key tile D/32 score
// chunks (Q 128 x 32, K 64 x 32) and D/32 dP chunks (dO 128 x 32, V 64 x
// 32) through one ring of stages, then K^T's W x 64 tile (f32_vt(k))
// through a ring of two; warps 1-3 write each K chunk's and K^T tile's lo
// copy.  Each consumer owns 64 q rows: S chunk by chunk (Q's fragments
// read from shared memory and split in registers), P from lse, dP on the
// CUDA cores, dS, and dq += dS K^T's tile; dq (W/2 registers) leaves from
// registers, rows below S only.  Registers a consumer thread (setmaxnreg
// 232): dq 64, then S or P 32 + a chunk's 32 + Q fragments 32, or P 32 +
// dP 32 + operands 20, or dS's fragments 64 + the tile's sum 64.
//
// dk/dv (flash_bwd_dkv_f32): a block owns (bh, 64-row k block, panel z of
// dk's and dv's columns) and walks the live 64-row q tiles.  dV and dK
// with their tiles' sums take 256 registers a thread at W 128, so the two
// consumers split the roles, as flash_bwd_kv.cuh's kv256 does for bf16 at
// D 256: consumer 0 forms S^T (split TF32, K chunks as A from registers,
// Q chunks as B with their lo), P^T, and dV += P^T dO^T's tile; consumer 1
// forms dP^T on the CUDA cores (V and dO chunks, no lo), dS^T from P^T,
// which consumer 0 hands over in f32 through a 16 KB exchange tile under
// two mbarriers (each thread's values where the other consumer's same
// thread holds dP^T's), and dK += dS^T Q^T's tile.  Rings: consumer 0's
// chunks (K, Q, Q's lo) and consumer 1's (V, dO), two or more stages
// each; one stage each of dO^T's and Q^T's W x 64 tiles with their lo.
//
// Past 128, panels of 128 columns on gridDim.z repeat S and dP in every
// panel block: at D 384 dq does 7 passes of products for the function's 3,
// dk/dv 8 for 4.  Every panel block streams its chunks in one order, chunk
// 0 first, so all of them form the same P and dS bit for bit.
//
// Left on the table: dS formed once per tile into shared memory and the
// panels walked from there (no repeated S and dP past 128); dP on the
// tensor cores with a check that allows its rounding; Q and dO (dq) and
// K, V (dk/dv) resident instead of re-read per tile; two stages of the
// transposed tiles; a persistent grid.  What each part costs (dP, the
// score products, the output products, each left out in turn:
// tools/chip_simt_probe.py --f32-bwd-parts) is in PERF.md.
#include "tf32.cuh"

namespace hvdf32 {

constexpr size_t ROOM = 229376;  // 224 KB of the 227 a block may use

// Element (r, c) of a 32-column f32 chunk, one 128-byte swizzled row per
// tile row: a byte offset from the chunk's 1024-aligned base.
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return swz<128>(r * 128 + c * 4);
}

// d = A B^T for one 32-column chunk in split TF32, in a fresh accumulator
// (trap 3): A the consumer's 64 rows from ra (its fragments read from
// shared memory and split in registers), B 64 rows K-major with its lo
// copy `lo` bytes on.
__device__ __forceinline__ void chunk_scores(float (&d)[32], const unsigned char* sa,
                                             int ra, int cq, const unsigned char* sb,
                                             size_t lo) {
  uint32_t ah[CW / 8][4], al[CW / 8][4];
#pragma unroll
  for (int kk = 0; kk < CW / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(*reinterpret_cast<const float*>(
                sa + chunk_off(ra + 8 * (e & 1), 8 * kk + cq + 4 * (e >> 1))),
            ah[kk][e], al[kk][e]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CW / 8; ++kk)
    mma3<64>(d, ah[kk], al[kk], desc_tf32(sb, 64, kk), desc_tf32(sb + lo, 64, kk),
             kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// y += A B^T for one 32-column chunk on the CUDA cores: a warp's 16 rows
// of A from a0 against the 64 rows of B, lane 8 g + c holding rows a0 + g +
// 4 i of A (i < 4) against rows c + 8 j of B (j < 8) in y[i][j], each one
// f32 fma chain over the chunk's columns in order, as the plain version's
// f32 product sums it.  A lane reads 4 + 8 rows of 16 bytes for every 4
// columns, where the accumulator's layout (2 rows against 16) would read
// 2 + 16; to_acc moves the sums into that layout.
__device__ __forceinline__ void chunk_dots(float (&y)[4][8], const unsigned char* sa,
                                           int a0, const unsigned char* sb, int lane) {
  const int g = lane / 8, c = lane % 8;
#pragma unroll 2
  for (int c4 = 0; c4 < CW / 4; ++c4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(sa + chunk_off(a0 + g + 4 * i, 4 * c4));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(sb + chunk_off(c + 8 * j, 4 * c4));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        y[i][j] = fmaf(a[i].w, b.w,
                       fmaf(a[i].z, b.z, fmaf(a[i].y, b.y, fmaf(a[i].x, b.x, y[i][j]))));
    }
  }
}

// chunk_dots' sums into the accumulator's layout (x[4 j + 2 h + e]: row r +
// 8 h, column 8 j + 2 q + e for lane 4 r + q) by shuffles within the warp:
// that element is y[r / 4 + 2 h][j] of lane 8 (r % 4) + 2 q + e.
__device__ __forceinline__ void to_acc(const float (&y)[4][8], float (&x)[32], int lane) {
  const int r = lane / 4, q = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int src = 8 * (r % 4) + 2 * q + e;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float lo = __shfl_sync(0xffffffffu, y[2 * h][j], src);
        const float hi = __shfl_sync(0xffffffffu, y[2 * h + 1][j], src);
        x[4 * j + 2 * h + e] = r >= 4 ? hi : lo;
      }
    }
}

// acc (W columns) += X B: X's 64 columns from a consumer's accumulator
// registers (P, dS, P^T or dS^T) as split TF32 A fragments, keys 2c and
// 2c + 1 of each group of 8 as the fragment's columns c and c + 4 (trap 2),
// B a W x 64 tile of a transposed copy in that order (two 32-column
// panels) with its lo copy `lo` bytes on; summed in a fresh accumulator,
// then added in f32 (trap 3).
template <int W>
__device__ __forceinline__ void tile_product(float (&acc)[W / 2], const float (&x)[32],
                                             const unsigned char* sb, size_t lo) {
  uint32_t h[8][4], l[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    split(x[4 * j], h[j][0], l[j][0]);
    split(x[4 * j + 2], h[j][1], l[j][1]);
    split(x[4 * j + 1], h[j][2], l[j][2]);
    split(x[4 * j + 3], h[j][3], l[j][3]);
  }
  float part[W / 2];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    mma3<W>(part, h[j], l[j], desc_tf32(sb, W, j), desc_tf32(sb + lo, W, j), j > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] += part[i];
}

// An accumulator's rows r, r + 8 (from row0) of W columns to f32 (rows, DW)
// at column col0, rows below S only.
template <int W>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[W / 2],
                                           int row0, int r, int c2, int col0, int S,
                                           int DW) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    if (row < S) {
      float* o = out + (size_t)row * DW + col0 + c2;
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
        *reinterpret_cast<float2*>(o + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// Whether P of q row q and key k is 0: a key past S, or causal, the key
// after the row.
template <bool CAUSAL>
__device__ __forceinline__ bool dead(int q, int k, int S) {
  return !(k < S && (!CAUSAL || k <= q));
}

// ------------------------------------------------------------------ dq

namespace dq {

constexpr int BQ = 128;  // q rows per block, 64 per consumer
constexpr int BK = 64;   // keys per tile

// SA chunk stages (a 128-row Q or dO chunk, a 64-row K or V chunk, the
// K chunk's lo), VS stages of K^T's W x 64 tile and its lo, the mbarriers.
template <int W>
struct Smem {
  static constexpr size_t qc = BQ * CW * 4;
  static constexpr size_t kc = BK * CW * 4;
  static constexpr size_t chunk = qc + 2 * kc;
  static constexpr size_t kt = (size_t)W * BK * 4;
  static constexpr int VS = 2;
  static constexpr int SA = (ROOM - VS * 2 * kt) / chunk < 6
                                ? (int)((ROOM - VS * 2 * kt) / chunk) : 6;
  static constexpr size_t ktiles = SA * chunk;
  static constexpr size_t bar = ktiles + VS * 2 * kt;
  static constexpr size_t bytes = bar + 8 * 3 * (SA + VS) + 1024;  // + alignment
  static_assert(SA >= 2 && bytes <= 232448, "a block's shared memory");
};

}  // namespace dq

template <int W, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_f32(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                 const __grid_constant__ CUtensorMap mkt, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ out, int S, int DW) {
  using L = dq::Smem<W>;
  constexpr int BQ = dq::BQ, BK = dq::BK, SA = L::SA, VS = L::VS;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* cfull = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* cready = cfull + SA;
  uint64_t* cempty = cready + SA;
  uint64_t* vfull = cempty + SA;
  uint64_t* vready = vfull + VS;
  uint64_t* vempty = vready + VS;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int z = blockIdx.z;                          // dq's columns [W z, W z + W)
  const int nc = DW / CW;
  const int nk = (S + BK - 1) / BK;
  const int kend = CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(&cfull[s], 1);
      mbar_init(&cready[s], NCONV);
      mbar_init(&cempty[s], 256);  // every consumer thread
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vready[s], NCONV);
      mbar_init(&vempty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_dec<40>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {  // per k tile nc score chunks, nc dP chunks, K^T's tile
      int n = 0;
      for (int i = 0; i < kend; ++i) {
        for (int c = 0; c < 2 * nc; ++c, ++n) {
          // one chunk order in every panel block: chunk 0 first
          const int s = n % SA, col = CW * (c % nc);
          const bool dp = c >= nc;
          mbar_wait(&cempty[s], ((n / SA) & 1) ^ 1);
          mbar_arrive_expect_tx(&cfull[s], L::qc + L::kc);
          unsigned char* st = smem + s * L::chunk;
          tma_load_3d(st, dp ? mg : mq, &cfull[s], col, q0, bh);
          tma_load_3d(st + L::qc, dp ? mv : mk, &cfull[s], col, i * BK, bh);
        }
        const int s = i % VS;
        mbar_wait(&vempty[s], ((i / VS) & 1) ^ 1);
        mbar_arrive_expect_tx(&vfull[s], L::kt);
        unsigned char* st = smem + L::ktiles + s * 2 * L::kt;
        for (int p = 0; p < BK / CW; ++p)
          tma_load_3d(st + p * W * 128, mkt, &vfull[s], i * BK + CW * p, W * z, bh);
      }
    } else if (pt >= 32) {  // lo copies of each K chunk and K^T tile
      const int ct = pt - 32;
      int n = 0;
      for (int i = 0; i < kend; ++i) {
        for (int c = 0; c < 2 * nc; ++c, ++n) {
          const int s = n % SA;
          mbar_wait(&cfull[s], (n / SA) & 1);
          if (c < nc) {  // a score chunk: K is a B operand (dP's V is not)
            unsigned char* sk = smem + s * L::chunk + L::qc;
            write_lo(sk, sk + L::kc, (int)(L::kc / 16), ct);
            fence_proxy_async();  // the lo copy is read by wgmma (async proxy)
          }
          mbar_arrive(&cready[s]);
        }
        const int s = i % VS;
        mbar_wait(&vfull[s], (i / VS) & 1);
        unsigned char* sv = smem + L::ktiles + s * 2 * L::kt;
        write_lo(sv, sv + L::kt, (int)(L::kt / 16), ct);
        fence_proxy_async();
        mbar_arrive(&vready[s]);
      }
    }
  } else {  // consumers: q rows [q0 + 64 wg, q0 + 64 wg + 64), dq's panel z
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rl = 64 * wg + 16 * (t / 32) + lane / 4;  // first row in the tile; +8
    const int cq = lane % 4, c2 = 2 * cq;
    float ls[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rl + 8 * h;
      ls[h] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      dl[h] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    float acc[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;

    int n = 0;  // chunks consumed
    for (int i = 0; i < kend; ++i) {
      const int k0 = i * BK;
      float sc[BK / 2];  // S, then P: rows rl, rl + 8 of BK keys
      for (int c = 0; c < nc; ++c, ++n) {
        const int s = n % SA;
        mbar_wait(&cfull[s], (n / SA) & 1);
        mbar_wait(&cready[s], (n / SA) & 1);
        const unsigned char* st = smem + s * L::chunk;
        float part[BK / 2];
        chunk_scores(part, st, rl, cq, st + L::qc, L::kc);
        mbar_arrive(&cempty[s]);
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) sc[x] = c > 0 ? sc[x] + part[x] : part[x];
      }
      // P = exp(S - lse), 0 where masked (only where the tile crosses this
      // consumer's diagonal or S)
      const bool masked = (CAUSAL && k0 + BK - 1 > q0 + 64 * wg) || k0 + BK > S;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + rl + 8 * (e >> 1), col = k0 + 8 * j + c2 + (e & 1);
          const float p = expf(sc[4 * j + e] - ls[e >> 1]);
          sc[4 * j + e] = masked && dead<CAUSAL>(row, col, S) ? 0.f : p;
        }
      // dP = dO V^T on the CUDA cores, then dS = P (dP - delta)
      float dpl[4][8] = {};  // chunk_dots' layout
      for (int c = 0; c < nc; ++c, ++n) {
        const int s = n % SA;
        mbar_wait(&cfull[s], (n / SA) & 1);
        mbar_wait(&cready[s], (n / SA) & 1);
        const unsigned char* st = smem + s * L::chunk;
        chunk_dots(dpl, st, 64 * wg + 16 * (t / 32), st + L::qc, lane);
        mbar_arrive(&cempty[s]);
      }
      float ds[BK / 2];
      to_acc(dpl, ds, lane);
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) ds[x] = sc[x] * (ds[x] - dl[(x >> 1) & 1]);
      // dq += dS K: K^T's tile (keys in f32_vt's order)
      const int s = i % VS;
      mbar_wait(&vfull[s], (i / VS) & 1);
      mbar_wait(&vready[s], (i / VS) & 1);
      tile_product<W>(acc, ds, smem + L::ktiles + s * 2 * L::kt, L::kt);
      mbar_arrive(&vempty[s]);
    }
    store_rows<W>(out + (size_t)bh * S * DW, acc, q0, rl, c2, W * z, S, DW);
  }
}

// ---------------------------------------------------------------- dk/dv

namespace dkv {

constexpr int BK = 64;  // k rows per block
constexpr int BQ = 64;  // q rows per tile

// Consumer 0's chunk ring (K chunk, Q chunk, Q chunk's lo), consumer 1's
// (V chunk, dO chunk), SR stages each; one stage each of dO^T's and Q^T's
// W x 64 tiles with their lo; the P^T exchange; the mbarriers.
template <int W>
struct Smem {
  static constexpr size_t c = 64 * CW * 4;  // one 64-row chunk, 8 KB
  static constexpr size_t achunk = 3 * c;
  static constexpr size_t bchunk = 2 * c;
  static constexpr size_t tt = (size_t)W * BQ * 4;
  static constexpr size_t xbytes = BK * BQ * 4;
  static constexpr size_t fit = (ROOM - 4 * tt - xbytes) / (achunk + bchunk);
  static constexpr int SR = fit < 4 ? (int)fit : 4;
  static constexpr size_t bring = SR * achunk;
  static constexpr size_t tiles = bring + SR * bchunk;
  static constexpr size_t xp = tiles + 4 * tt;
  static constexpr size_t bar = xp + xbytes;
  static constexpr size_t bytes = bar + 8 * (5 * SR + 8) + 1024;  // + alignment
  static_assert(SR >= 2 && bytes <= 232448, "a block's shared memory");
};

}  // namespace dkv

template <int W, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_f32(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                  const __grid_constant__ CUtensorMap mqt, const __grid_constant__ CUtensorMap mgt,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int S, int DW) {
  using L = dkv::Smem<W>;
  constexpr int BQ = dkv::BQ, BK = dkv::BK, SR = L::SR;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* afull = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* aready = afull + SR;
  uint64_t* aempty = aready + SR;
  uint64_t* bfull = aempty + SR;
  uint64_t* bempty = bfull + SR;
  uint64_t* tfull = bempty + SR;  // [0] dO^T (consumer 0), [1] Q^T (consumer 1)
  uint64_t* tready = tfull + 2;
  uint64_t* tempty = tready + 2;
  uint64_t* xfull = tempty + 2;  // P^T written (consumer 0's 128 threads)
  uint64_t* xempty = xfull + 1;  // P^T read (consumer 1's 128 threads)
  float* xp = reinterpret_cast<float*>(smem + L::xp);

  // bh on gridDim.x; k block 0, the longest causal one, first
  const int bh = blockIdx.x, k0 = blockIdx.y * BK, z = blockIdx.z;
  const int nc = DW / CW;
  const int nq = (S + BQ - 1) / BQ;
  const int qstart = CAUSAL ? k0 / BQ : 0;  // tiles before lie above the diagonal
  const int nt = nq - qstart;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SR; ++s) {
      mbar_init(&afull[s], 1);
      mbar_init(&aready[s], NCONV);
      mbar_init(&aempty[s], 128);  // consumer 0
      mbar_init(&bfull[s], 1);
      mbar_init(&bempty[s], 128);  // consumer 1
    }
    for (int r = 0; r < 2; ++r) {
      mbar_init(&tfull[r], 1);
      mbar_init(&tready[r], NCONV);
      mbar_init(&tempty[r], 128);
    }
    mbar_init(xfull, 128);
    mbar_init(xempty, 128);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_dec<40>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {  // per q tile nc chunks into each ring, then the two T tiles
      int n = 0;
      for (int i = 0; i < nt; ++i) {
        const int q0 = (qstart + i) * BQ;
        for (int c = 0; c < nc; ++c, ++n) {  // chunk 0 first in every panel block
          const int s = n % SR, col = CW * c, par = ((n / SR) & 1) ^ 1;
          unsigned char* sa = smem + s * L::achunk;
          mbar_wait(&aempty[s], par);
          mbar_arrive_expect_tx(&afull[s], 2 * L::c);
          tma_load_3d(sa, mk, &afull[s], col, k0, bh);
          tma_load_3d(sa + L::c, mq, &afull[s], col, q0, bh);
          unsigned char* sb = smem + L::bring + s * L::bchunk;
          mbar_wait(&bempty[s], par);
          mbar_arrive_expect_tx(&bfull[s], 2 * L::c);
          tma_load_3d(sb, mv, &bfull[s], col, k0, bh);
          tma_load_3d(sb + L::c, mg, &bfull[s], col, q0, bh);
        }
        for (int r = 0; r < 2; ++r) {
          unsigned char* st = smem + L::tiles + r * 2 * L::tt;
          mbar_wait(&tempty[r], (i & 1) ^ 1);
          mbar_arrive_expect_tx(&tfull[r], L::tt);
          for (int p = 0; p < BQ / CW; ++p)
            tma_load_3d(st + p * W * 128, r ? mqt : mgt, &tfull[r], q0 + CW * p, W * z,
                        bh);
        }
      }
    } else if (pt >= 32) {  // lo copies of each Q chunk and T tile
      const int ct = pt - 32;
      int n = 0;
      for (int i = 0; i < nt; ++i) {
        for (int c = 0; c < nc; ++c, ++n) {
          const int s = n % SR;
          mbar_wait(&afull[s], (n / SR) & 1);
          unsigned char* sq = smem + s * L::achunk + L::c;
          write_lo(sq, sq + L::c, (int)(L::c / 16), ct);
          fence_proxy_async();  // the lo copy is read by wgmma (async proxy)
          mbar_arrive(&aready[s]);
        }
        for (int r = 0; r < 2; ++r) {
          unsigned char* st = smem + L::tiles + r * 2 * L::tt;
          mbar_wait(&tfull[r], i & 1);
          write_lo(st, st + L::tt, (int)(L::tt / 16), ct);
          fence_proxy_async();
          mbar_arrive(&tready[r]);
        }
      }
    }
  } else {  // consumers of k rows [k0, k0 + 64): 0 owns dV, 1 owns dK
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rl = 16 * (t / 32) + lane / 4;  // first k row of the block; +8
    const int cq = lane % 4, c2 = 2 * cq;     // first q column of a pair
    unsigned char* st = smem + L::tiles + wg * 2 * L::tt;  // dO^T or Q^T
    float acc[W / 2];  // dV (consumer 0) or dK (consumer 1)
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;

    int n = 0;  // chunks of this consumer's ring
    for (int i = 0; i < nt; ++i) {
      const int q0 = (qstart + i) * BQ;
      // lse (consumer 0) or delta (consumer 1) of the q columns held
      float rows[BQ / 4];
      const float* src = wg ? delta : lse;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + 8 * j + c2 + e;
          rows[2 * j + e] = q < S ? src[(size_t)bh * S + q] : 0.f;
        }
      float x[BQ / 2];  // S^T then P^T, or dP^T then dS^T: k rows rl, rl + 8
      if (wg == 0) {
        for (int c = 0; c < nc; ++c, ++n) {
          const int s = n % SR;
          mbar_wait(&afull[s], (n / SR) & 1);
          mbar_wait(&aready[s], (n / SR) & 1);
          const unsigned char* sa = smem + s * L::achunk;
          float part[BQ / 2];
          chunk_scores(part, sa, rl, cq, sa + L::c, L::c);
          mbar_arrive(&aempty[s]);
#pragma unroll
          for (int y = 0; y < BQ / 2; ++y) x[y] = c > 0 ? x[y] + part[y] : part[y];
        }
        // P^T = exp(S^T - lse), 0 where masked, to the exchange tile in
        // f32 (thread t's values at [y][t], the layout in which consumer
        // 1's thread t holds dP^T)
        const bool masked = (CAUSAL && q0 < k0 + BK - 1) || q0 + BQ > S || k0 + BK > S;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + 8 * j + c2 + (e & 1), k = k0 + rl + 8 * (e >> 1);
            const float p = expf(x[4 * j + e] - rows[2 * j + (e & 1)]);
            x[4 * j + e] = masked && (q >= S || dead<CAUSAL>(q, k, S)) ? 0.f : p;
          }
        mbar_wait(xempty, (i & 1) ^ 1);  // consumer 1 has read the last P^T
#pragma unroll
        for (int y = 0; y < BQ / 2; ++y) xp[y * 128 + t] = x[y];
        mbar_arrive(xfull);
      } else {
        float dpl[4][8] = {};  // dP^T = V dO^T on the CUDA cores
        for (int c = 0; c < nc; ++c, ++n) {
          const int s = n % SR;
          mbar_wait(&bfull[s], (n / SR) & 1);
          const unsigned char* sb = smem + L::bring + s * L::bchunk;
          chunk_dots(dpl, sb, 16 * (t / 32), sb + L::c, lane);
          mbar_arrive(&bempty[s]);
        }
        to_acc(dpl, x, lane);
        mbar_wait(xfull, i & 1);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[4 * j + e] = xp[(4 * j + e) * 128 + t] * (x[4 * j + e] - rows[2 * j + (e & 1)]);
        mbar_arrive(xempty);
      }
      // consumer 0: dV += P^T dO; consumer 1: dK += dS^T Q (T tiles in
      // f32_vt's q order)
      mbar_wait(&tfull[wg], i & 1);
      mbar_wait(&tready[wg], i & 1);
      tile_product<W>(acc, x, st, L::tt);
      mbar_arrive(&tempty[wg]);
    }
    store_rows<W>((wg ? dk : dv) + (size_t)bh * S * DW, acc, k0, rl, c2, W * z, S, DW);
  }
}

// ------------------------------------------------------------ launches

template <int W, bool CAUSAL>
static cudaError_t launch_dq(const CUtensorMap (&m)[4], const float* kt, const float* lse,
                             const float* delta, float* out, int bh, int s, int d,
                             cudaStream_t stream) {
  using L = dq::Smem<W>;
  CUtensorMap mkt;
  cudaError_t err = panel_map<CW>(&mkt, kt, d, bh, W, (s + 7) / 8 * 8);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_f32<W, CAUSAL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + dq::BQ - 1) / dq::BQ, d / W);
  kernel<<<grid, 384, L::bytes, stream>>>(m[0], m[1], m[2], m[3], mkt, lse, delta, out,
                                          s, d);
  return cudaGetLastError();
}

template <int W, bool CAUSAL>
static cudaError_t launch_dkv(const CUtensorMap (&m)[4], const float* qt, const float* gt,
                              const float* lse, const float* delta, float* dk, float* dv,
                              int bh, int s, int d, cudaStream_t stream) {
  using L = dkv::Smem<W>;
  CUtensorMap mqt, mgt;
  cudaError_t err;
  if ((err = panel_map<CW>(&mqt, qt, d, bh, W, (s + 7) / 8 * 8)) != cudaSuccess ||
      (err = panel_map<CW>(&mgt, gt, d, bh, W, (s + 7) / 8 * 8)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_dkv_f32<W, CAUSAL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + dkv::BK - 1) / dkv::BK, d / W);
  kernel<<<grid, 384, L::bytes, stream>>>(m[0], m[1], m[2], m[3], mqt, mgt, lse, delta, dk,
                                          dv, s, d);
  return cudaGetLastError();
}

// The maps of q, k, v and g: 32-column chunks of `qrows` rows for q and g,
// 64 rows for k and v.
static cudaError_t input_maps(CUtensorMap (&m)[4], const float* q, const float* k,
                              const float* v, const float* g, int bh, int s, int d,
                              uint32_t qrows) {
  cudaError_t err;
  if ((err = panel_map<CW>(&m[0], q, s, bh, qrows, d)) != cudaSuccess ||
      (err = panel_map<CW>(&m[1], k, s, bh, 64, d)) != cudaSuccess ||
      (err = panel_map<CW>(&m[2], v, s, bh, 64, d)) != cudaSuccess)
    return err;
  return panel_map<CW>(&m[3], g, s, bh, qrows, d);
}

}  // namespace hvdf32

// q, k, v, g (BH, S, D) f32; kt (BH, D, S8) f32: K^T with S zero-padded to
// a multiple of 8 and each group of 8 keys in the order 0, 2, 4, 6, 1, 3,
// 5, 7 (ops/flash_attention.py f32_vt); lse, delta (BH, S) f32; out, dq
// (BH, S, D) f32.  d: 32, 64, 128, 256, or a multiple of 128 past 256.  Returns a
// cudaError_t (cudaErrorInvalidValue for a d it does not take).
extern "C" int hvd_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* g, const void* kt, const void* lse,
                                    const void* delta, void* out, int bh, int s, int d,
                                    int causal, void* stream) {
  using namespace hvdf32;
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap m[4];
  cudaError_t err = input_maps(m, static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), static_cast<const float*>(g),
                               bh, s, d, dq::BQ);
  if (err != cudaSuccess) return err;
  const float *fkt = static_cast<const float*>(kt), *fl = static_cast<const float*>(lse),
              *fd = static_cast<const float*>(delta);
  float* fo = static_cast<float*>(out);
  if (d != 32 && d != 64 && d % 128) return cudaErrorInvalidValue;
  if (causal) {
    if (d == 32) return launch_dq<32, true>(m, fkt, fl, fd, fo, bh, s, d, st);
    if (d == 64) return launch_dq<64, true>(m, fkt, fl, fd, fo, bh, s, d, st);
    return launch_dq<128, true>(m, fkt, fl, fd, fo, bh, s, d, st);
  }
  if (d == 32) return launch_dq<32, false>(m, fkt, fl, fd, fo, bh, s, d, st);
  if (d == 64) return launch_dq<64, false>(m, fkt, fl, fd, fo, bh, s, d, st);
  return launch_dq<128, false>(m, fkt, fl, fd, fo, bh, s, d, st);
}

// q, k, v, g (BH, S, D) f32; qt, gt (BH, D, S8) f32: Q^T and dO^T in
// f32_vt's layout; lse, delta (BH, S) f32; dk, dv (BH, S, D) f32.  d as
// above.
extern "C" int hvd_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* g, const void* qt, const void* gt,
                                     const void* lse, const void* delta, void* dk,
                                     void* dv, int bh, int s, int d, int causal,
                                     void* stream) {
  using namespace hvdf32;
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap m[4];
  cudaError_t err = input_maps(m, static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), static_cast<const float*>(g),
                               bh, s, d, dkv::BQ);
  if (err != cudaSuccess) return err;
  const float *fq = static_cast<const float*>(qt), *fg = static_cast<const float*>(gt),
              *fl = static_cast<const float*>(lse), *fd = static_cast<const float*>(delta);
  float *fk = static_cast<float*>(dk), *fv = static_cast<float*>(dv);
  if (d != 32 && d != 64 && d % 128) return cudaErrorInvalidValue;
  if (causal) {
    if (d == 32) return launch_dkv<32, true>(m, fq, fg, fl, fd, fk, fv, bh, s, d, st);
    if (d == 64) return launch_dkv<64, true>(m, fq, fg, fl, fd, fk, fv, bh, s, d, st);
    return launch_dkv<128, true>(m, fq, fg, fl, fd, fk, fv, bh, s, d, st);
  }
  if (d == 32) return launch_dkv<32, false>(m, fq, fg, fl, fd, fk, fv, bh, s, d, st);
  if (d == 64) return launch_dkv<64, false>(m, fq, fg, fl, fd, fk, fv, bh, s, d, st);
  return launch_dkv<128, false>(m, fq, fg, fl, fd, fk, fv, bh, s, d, st);
}
