// Flash-attention forward for Hopper (sm_90a) in float32, at head dims 32,
// 64, 128, 256 and every multiple of 128 past 256, on the tensor cores as
// split TF32.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_attn_kernel, launched by
// _flash_attention_fwd_flat, at f32 inputs.  Same function as
// flash_fwd_reference in f32: causal or full attention on a q already
// scaled by 1/sqrt(D); S = Q K^T; masked scores -1e30; an online softmax
// keeps m, l and O in f32 (under f32 every cast of the TPU kernel is the
// identity, so the online form computes the plain version's function up
// to the order of its f32 sums); l clamped at 1e-30; out: O = P V / l in
// f32 and the row log-sum-exp in f32, natural-log units.  Tiles wholly
// above the diagonal are skipped.
//
// Bound on the H100 SXM: operations.  The function's f32 products at the
// CUDA cores' 67 TFLOP/s: at the decoder's shape (BH 32, S 2048, D 128,
// causal) 4*BH*D*S*(S+1)/2 = 34.4 GFLOP, 0.513 ms; at D 384 103 GFLOP,
// 1.539 ms.  As split TF32 the tensor cores run three TF32 products for
// each f32 one, at 495 TFLOP/s: 0.208 ms at D 128, 0.416 at D 256, 0.624
// at D 384, 0.117 at BERT-Large's shape (BH 512, S 384, D 64, full).  The
// bytes (each f32 input read once, the outputs written once) take 0.04 ms
// at the decoder's shape.
//
// The split.  TF32 keeps 10 of an f32's 23 mantissa bits, so one TF32
// product of f32 operands is off by about 2^-11 of its value.  Each
// operand x is written as hi + lo: hi its top 19 bits (sign, exponent and
// the top 10 mantissa bits: the part of an f32 word that the tensor core
// reads, the rest it ignores), lo = x - hi, exact in f32 and at most 2^-10
// of x.  a b = a_lo b_hi + a_hi b_lo + a_hi b_hi + a_lo b_lo: the last
// term, at most 2^-20 of the product, is dropped, and the tensor core's
// truncation of lo to TF32 costs at most 2^-10 of a small term, so each
// product is within about 2^-19 of its f32 value, below the 2^-16 limits
// that the f32 plain version holds this kernel to.  Per k-step the two
// small terms go into the f32 accumulator first, then hi hi (CUTLASS's
// fast-f32 order).  An f32 tile in shared memory already serves as its own
// hi, so only lo needs a second copy; the register operands (Q's rows,
// P) are split in registers, hi masked explicitly.
//
// Trap 1: TF32 wgmma takes both operands K-major only (the transpose bits
// exist only for f16 and bf16).  S = Q K^T is K-major as stored (K's rows
// run along D).  O = P V needs V as V^T, contiguous along the keys: the
// wrapper passes that copy (ops/flash_attention.py f32_vt; its time is
// part of the kernel's recorded time), zero-padded to a multiple of 8 keys.
//
// Trap 2: P does not sit in TF32's A-operand register layout.  S's
// accumulator gives a thread columns {2c, 2c + 1} of each group of 8 (c =
// lane % 4), while a TF32 A fragment (m64 x k8, four registers) wants
// columns {c, c + 4} (a0: row r, column c; a1: row r + 8, column c; a2, a3
// the same at column c + 4).  The sum over keys does not care about their
// order, so f32_vt stores the keys of each group of 8 in the order 0, 2, 4,
// 6, 1, 3, 5, 7: A's column c is then key 2c and its column c + 4 key
// 2c + 1, and P goes from S's registers to the PV product with no shuffle
// (a = {s[4j], s[4j + 2], s[4j + 1], s[4j + 3]} for keys 8j..8j + 7).
//
// Trap 3: the tensor core's f32 accumulation truncates.  Each product's
// sum into its accumulator drops the bits past f32's 24 (toward zero, the
// error one-signed), so a long chain into one accumulator drifts: summing
// all of a row's keys into O (3 products per 8 keys) and all of D into S
// read up to 2.7 of the limits at BH 32, S 2048 (and 1.7 at D 640, S
// 200) on an H100, where a torch emulation of the split alone read 0.66
// (tools/chip_simt_probe.py --f32-fwd, --f32-split).  So S is summed per
// 32-column chunk (12 products) in a fresh accumulator and P V per
// 64-key tile (24 products), each then added to its running sum in f32
// registers, rounded to nearest: the emulation with truncating sums
// (tests/test_torch_port_hopper_f32_fwd.py) read 3.65 at D 384, S 2048
// in one chain per row and 0.605 in these chains.  The second
// accumulator costs W/2 registers a thread, so O's panels are at most
// 128 columns (at W 256, O and its tile sum would hold 256).
//
// Design (flash_fwd.cu's wide plan at every width: an f32 tile with its lo
// copy takes 8 bytes an element of shared memory, so D 128 here is sized
// like bf16 at D 512).  A block owns (bh, 128-row q tile, O panel z):
// columns [W z, W z + W) of O, W = D up to 128, and from 256 on panels of
// 128 (the scores formed D / 128 times: trap 3's registers).  Three
// warpgroups.  The producer gives up registers (setmaxnreg); its thread 0
// starts TMA loads, per k tile of 64 keys D/32 score chunks (a 128 x 32 Q
// chunk and a 64 x 32 K chunk, one 128-byte swizzle row each) through a
// ring of SA stages, then V^T's 64 keys of the panel's W rows through a
// ring of two; its warps 1-3 write each K chunk's and each V^T tile's lo
// copy beside it as it lands, and hand the stage on through a "ready"
// mbarrier.  The two consumers own 64 q rows each: per chunk they read
// their Q fragments from shared memory (ld.shared), split them in
// registers, and form the chunk's 3 x 4 products m64n64k8, added to S;
// every panel block streams the chunks in one order, chunk 0 first, so all
// blocks of a q tile form the same S, m, l and P bit for bit, and only
// panel 0 writes lse.  Then the online softmax on S's registers (the mask
// only where the tile crosses the diagonal or S), P split in registers,
// and the tile's P V^T by 3 x 8 products m64nWk8 with P from registers,
// added to O.  O / l leaves from registers straight to device memory, rows
// below S only.
//
// Left on the table: 256-column panels (O's running sum in shared memory,
// or the tile's P V in column quarters), Q resident in shared memory up to
// D 64 (re-read per k tile here), the next chunk's Q fragments loaded
// while this one's products run, overlap of the softmax with the next
// tile's products, ping-pong consumers, a persistent grid.
#include "tf32.cuh"

namespace hvdf32 {

constexpr int BQ = 128;   // q rows per block, 64 per consumer warpgroup
constexpr int BK = 64;    // keys per k tile
constexpr float NEG_INF = -1e30f;  // the mask value of the TPU kernels

// Shared memory of a block that owns an O panel of W columns: SA chunk
// stages (Q chunk, K chunk, K chunk's lo), then VS stages of V^T's W x 64
// tile and its lo, then the mbarriers (full, ready, empty per stage).
// Every tile starts on 1024 bytes, as the 128-byte swizzle wants.
template <int W>
struct Smem {
  static constexpr size_t qc = BQ * CW * 4;
  static constexpr size_t kc = BK * CW * 4;
  static constexpr size_t chunk = qc + 2 * kc;
  static constexpr size_t vt = (size_t)W * BK * 4;
  static constexpr int VS = 2;
  static constexpr size_t room = 229376;  // 224 KB of the 227 a block may use
  static constexpr int SA = (room - VS * 2 * vt) / chunk < 6
                                ? (int)((room - VS * 2 * vt) / chunk) : 6;
  static constexpr size_t v = SA * chunk;
  static constexpr size_t bar = v + VS * 2 * vt;
  static constexpr size_t bytes = bar + 8 * 3 * (SA + VS) + 1024;  // + alignment
  static_assert(SA >= 2 && bytes <= 232448, "a block's shared memory");
};

// The k tiles that the q tile from q0 reads: causal, tile t is live while
// t*BK <= q0 + BQ - 1.
template <bool CAUSAL>
__device__ __forceinline__ int live_tiles(int q0, int S) {
  const int nk = (S + BK - 1) / BK;
  return CAUSAL ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
}

// One k tile of the online softmax on a consumer thread's S registers
// (rows r0 and r0 + 8 of BK columns from k0; w0 is its warpgroup's first
// row): the mask where the tile crosses the diagonal or S, the running max
// and sum, O's W-column accumulator rescaled, and S turned into P.
template <int W, bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&o)[W / 2],
                                             float (&m)[2], float (&l)[2], int r0,
                                             int w0, int k0, int c2, int S) {
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
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = expf(m[h] - mx[h]);
    m[h] = mx[h];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(sc[4 * j + e] - m[e >> 1]);
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
  for (int j = 0; j < W / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// O (W columns) += P V: P split from S's registers into TF32 A fragments
// (trap 2: keys 2c and 2c + 1 of each group of 8 are A's columns c and
// c + 4, the order f32_vt stores V^T's keys in), V^T's W x BK tile (two
// 32-key panels) and its lo copy from shared memory; the tile's products
// summed in a fresh accumulator, then added to O in f32 (trap 3).
template <int W>
__device__ __forceinline__ void pv_tile(float (&o)[W / 2], const float (&sc)[BK / 2],
                                        const unsigned char* sv) {
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    split(sc[4 * j], ph[j][0], pl[j][0]);
    split(sc[4 * j + 2], ph[j][1], pl[j][1]);
    split(sc[4 * j + 1], ph[j][2], pl[j][2]);
    split(sc[4 * j + 3], ph[j][3], pl[j][3]);
  }
  float ot[W / 2];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
    mma3<W>(ot, ph[j], pl[j], desc_tf32(sv, W, j), desc_tf32(sv + Smem<W>::vt, W, j),
            j > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(ot);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] += ot[i];
}

template <int W, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mvt,
                     float* __restrict__ out, float* __restrict__ lse, int S, int DW) {
  using L = Smem<W>;
  constexpr int SA = L::SA, VS = L::VS;
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
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * BQ;
  const int z = blockIdx.z;  // O's columns [W z, W z + W)
  const int nc = DW / CW;
  const int kend = live_tiles<CAUSAL>(q0, S);
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
    if (pt == 0) {  // TMA: per k tile nc score chunks, then V^T's tile
      int n = 0;  // chunks requested
      for (int i = 0; i < kend; ++i) {
        for (int c = 0; c < nc; ++c, ++n) {
          // one chunk order in every panel block: chunk 0 first
          const int s = n % SA, col = CW * c;
          mbar_wait(&cempty[s], ((n / SA) & 1) ^ 1);
          mbar_arrive_expect_tx(&cfull[s], L::qc + L::kc);
          unsigned char* st = smem + s * L::chunk;
          tma_load_3d(st, mq, &cfull[s], col, q0, bh);
          tma_load_3d(st + L::qc, mk, &cfull[s], col, i * BK, bh);
        }
        const int s = i % VS;
        mbar_wait(&vempty[s], ((i / VS) & 1) ^ 1);
        mbar_arrive_expect_tx(&vfull[s], L::vt);
        unsigned char* st = smem + L::v + s * 2 * L::vt;
        for (int p = 0; p < BK / CW; ++p)
          tma_load_3d(st + p * W * 128, mvt, &vfull[s], i * BK + CW * p, W * z, bh);
      }
    } else if (pt >= 32) {  // lo copies of each K chunk and V^T tile
      const int ct = pt - 32;
      int n = 0;
      for (int i = 0; i < kend; ++i) {
        for (int c = 0; c < nc; ++c, ++n) {
          const int s = n % SA;
          mbar_wait(&cfull[s], (n / SA) & 1);
          unsigned char* sk = smem + s * L::chunk + L::qc;
          write_lo(sk, sk + L::kc, (int)(L::kc / 16), ct);
          fence_proxy_async();  // the lo copy is read by wgmma (async proxy)
          mbar_arrive(&cready[s]);
        }
        const int s = i % VS;
        mbar_wait(&vfull[s], (i / VS) & 1);
        unsigned char* sv = smem + L::v + s * 2 * L::vt;
        write_lo(sv, sv + L::vt, (int)(L::vt / 16), ct);
        fence_proxy_async();
        mbar_arrive(&vready[s]);
      }
    }
  } else {  // consumers: rows [q0 + 64 wg, q0 + 64 wg + 64), O's panel z
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rl = 64 * wg + 16 * (t / 32) + lane / 4;  // first row in the tile; +8
    const int cq = lane % 4, c2 = 2 * cq;  // A's column; S's first column of a pair
    float o[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    int n = 0;  // chunks consumed
    for (int i = 0; i < kend; ++i) {
      float sc[BK / 2];  // S, then P: rows rl, rl + 8 of BK columns
      for (int c = 0; c < nc; ++c, ++n) {
        const int s = n % SA;
        mbar_wait(&cfull[s], (n / SA) & 1);
        mbar_wait(&cready[s], (n / SA) & 1);
        const unsigned char* sq = smem + s * L::chunk;
        const unsigned char* sk = sq + L::qc;
        uint32_t qh[CW / 8][4], ql[CW / 8][4];  // A fragments, k-step kk
#pragma unroll
        for (int kk = 0; kk < CW / 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split(*reinterpret_cast<const float*>(
                      sq + panel_offset<CW, BQ, 4>(rl + 8 * (e & 1),
                                                   8 * kk + cq + 4 * (e >> 1))),
                  qh[kk][e], ql[kk][e]);
        float scc[BK / 2];  // this chunk's products (trap 3)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CW / 8; ++kk)
          mma3<BK>(scc, qh[kk], ql[kk], desc_tf32(sk, BK, kk),
                   desc_tf32(sk + L::kc, BK, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(scc);
        mbar_arrive(&cempty[s]);
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) sc[x] = c > 0 ? sc[x] + scc[x] : scc[x];
      }

      softmax_tile<W, CAUSAL>(sc, o, m, l, q0 + rl, q0 + 64 * wg, i * BK, c2, S);
      const int s = i % VS;
      mbar_wait(&vfull[s], (i / VS) & 1);
      mbar_wait(&vready[s], (i / VS) & 1);
      pv_tile<W>(o, sc, smem + L::v + s * 2 * L::vt);
      mbar_arrive(&vempty[s]);
    }

    // Epilogue: O / l straight to this panel's columns of the rows below
    // S; lse = m + log(l) from panel 0 alone (every panel holds the same m
    // and l).
    float* ob = out + (size_t)bh * S * DW + W * z + c2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lc = fmaxf(l[h], 1e-30f);
      const int row = q0 + rl + 8 * h;
      if (row < S) {
        if (z == 0 && cq == 0) lse[(size_t)bh * S + row] = m[h] + logf(lc);
#pragma unroll
        for (int j = 0; j < W / 8; ++j)
          *reinterpret_cast<float2*>(ob + (size_t)row * DW + 8 * j) =
              make_float2(o[4 * j + 2 * h] / lc, o[4 * j + 2 * h + 1] / lc);
      }
    }
  }
}

// O in d / W panels of W columns each, one block each on gridDim.z; vt is
// (BH, D, S8) f32.
template <int W, bool CAUSAL>
static cudaError_t launch_panels(const CUtensorMap& mq, const CUtensorMap& mk,
                                 const float* vt, float* o, float* lse, int bh, int s,
                                 int d, cudaStream_t stream) {
  using L = Smem<W>;
  CUtensorMap mvt;
  cudaError_t err = panel_map<CW>(&mvt, vt, d, bh, W, (s + 7) / 8 * 8);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_f32_kernel<W, CAUSAL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + BQ - 1) / BQ, d / W);
  kernel<<<grid, 384, L::bytes, stream>>>(mq, mk, mvt, o, lse, s, d);
  return cudaGetLastError();
}

// Up to 128 one panel of d columns; from 256 on (a multiple of 128) d / 128
// panels of 128 columns.
template <bool CAUSAL>
static cudaError_t launch(const float* q, const float* k, const float* vt, float* o,
                          float* lse, int bh, int s, int d, cudaStream_t st) {
  CUtensorMap mq, mk;
  cudaError_t err;
  if ((err = panel_map<CW>(&mq, q, s, bh, BQ, d)) != cudaSuccess ||
      (err = panel_map<CW>(&mk, k, s, bh, BK, d)) != cudaSuccess)
    return err;
  if (d == 32) return launch_panels<32, CAUSAL>(mq, mk, vt, o, lse, bh, s, d, st);
  if (d == 64) return launch_panels<64, CAUSAL>(mq, mk, vt, o, lse, bh, s, d, st);
  if (d % 128) return cudaErrorInvalidValue;
  return launch_panels<128, CAUSAL>(mq, mk, vt, o, lse, bh, s, d, st);
}

}  // namespace hvdf32

// q, k, o (BH, S, D) f32; vt (BH, D, S8) f32: V^T with S zero-padded to a
// multiple of 8 and each group of 8 keys in the order 0, 2, 4, 6, 1, 3, 5,
// 7 (ops/flash_attention.py f32_vt); lse (BH, S) f32.  d: 32, 64, 128, 256,
// or a multiple of 128 past 256.  Returns a cudaError_t
// (cudaErrorInvalidValue for a d it does not take).
extern "C" int hvd_flash_fwd_f32(const void* q, const void* k, const void* vt, void* o,
                                 void* lse, int bh, int s, int d, int causal,
                                 void* stream) {
  using namespace hvdf32;
  auto st = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(vt);
  float *fo = static_cast<float*>(o), *fl = static_cast<float*>(lse);
  return causal ? launch<true>(fq, fk, fv, fo, fl, bh, s, d, st)
                : launch<false>(fq, fk, fv, fo, fl, bh, s, d, st);
}
