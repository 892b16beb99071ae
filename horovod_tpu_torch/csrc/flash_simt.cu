// Flash attention in float32, float16 and bfloat16 on the CUDA cores
// (sm_90a): the four flash kernels of flash_fwd.cu, flash_bwd.cu and
// flash_bwd_onepass.cu for what the Hopper versions do not take: f32 at
// any width, and the backward in every dtype past head dim 256.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_attn_kernel (via
// _flash_attention_fwd_flat), _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel
// (via _flash_attention_bwd_flat) and _flash_bwd_onepass_kernel (via
// _flash_attention_bwd_onepass_flat), at f32, f16 and bf16 inputs and head
// dims 32, 64, 128, 256 and every multiple of 128 past 256 (the JAX package
// pads a head dim to a multiple of 128 and computes any).  Same functions
// and casts as those and as the Hopper kernels: products of inputs in T
// with f32 accumulation; P is cast to V's dtype before PV, dS to K's (dq
// and the dq partials) and Q's (dk) before its products, P to dO's before
// dv; masked scores are dropped (the TPU kernels' -1e30, whose exp is 0);
// lse and delta are f32 (BH, S) rows.  Under f32 every cast is the
// identity.  Outputs: O in T and the f32 row log-sum-exp (natural log); dq
// f32 in the pre-scaled units; dk, dv in T; the one-pass kernel's dq
// partials f32, one (S, W) slot per 128 rows of k (per 64 at D 256, as the
// Hopper one-pass there), a slot the causal mask kills all zeros.  No conversion flushes an f16 subnormal to zero.
//
// Bound on the H100 SXM: operations.  Exact f32 products are not tensor-core
// work (TF32 keeps about three decimal digits and would no longer compute
// the f32 function), so f32 is held to the 67 TFLOP/s of the CUDA cores: at
// the decoder's shape (BH 32, S 2048, D 128, causal) the forward's 34.4
// GFLOP take 0.51 ms, against 134 MB of f32 tensors (0.04 ms at 3.35 TB/s).
// f16 and bf16 run the same CUDA-core code, so their bound against the
// card's tensor-core peak is far below what this design can reach.
//
// Design: simple and tiled, on purpose.  No wgmma and no TMA.  A block of
// 256 threads owns M rows (of q for the forward and dq, of k for dk/dv) of
// one D-column panel of the outputs.  Up to 256 the panel is the whole
// width W: M is 64, or 32 at D 256, where four 64-row f32 tiles of 257
// floats a row would pass the 227 KB a block may use.  Past 256, W is W /
// 128 panels of 128 columns on gridDim.z (M 64), each block writing one
// panel of o, dq, dk and dv or of the one-pass partials: the scores (S = Q
// K^T, and dP = dO V^T for the backward) still take every column, their
// operands streamed through the same tiles one panel after another, panel
// 0 first, so that every block of a row tile sums them in one order and
// forms the same P bit for bit (only panel 0 writes lse).  W / 128 is then
// a loop count at run time, and registers and shared memory stay at the
// D 128 plan's; the price is the scores recomputed W / 128 times.  Tiles
// of M rows live in shared memory as f32 (whatever T is) with a row stride
// of D + 1 (odd, so that a column walk hits 32 banks); each thread holds an
// R x R block (R = M / 16) of an M x M score tile, and an R x D/16 block of
// an M x D output panel, in registers.  The forward takes two passes over
// the k tiles: the first finds each row's max, the second forms P = exp(S
// - max) with that final max, casts it to T, and accumulates PV and the
// row sum.  An online softmax would cast P at a running max and so round
// it at other places than the plain version does; with the final max, the
// kernel and its plain version cast the same values and differ only by
// the order of f32 sums, which lets the check on the card see a missing
// cast.  The price is S = Q K^T computed twice.  The one-pass kernel's
// block owns the k rows of one dq partial slot (128, or 64 at D 256), as
// 128 / M or 64 / M tiles one after the other: the first writes each q
// tile's partial, each later one adds its own to it (the same thread, the
// same element), so no atomics and a fixed order.  Every output element has one writer.
//
// Left on the table: register tiles fed by vector loads from shared
// memory, more blocks per SM at D 128, an online softmax (one pass) once a
// tolerance for it is set, the scores formed once for all panels past 256,
// and a Hopper backward past 256.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace hvdsimt {

constexpr int NT = 256;          // threads a block: 16 x 16
// rows of k per dq partial slot: 128, and 64 at D 256 (the Hopper
// one-pass's slots there); past 256 the panel instances are D 128's
template <int D>
__host__ __device__ constexpr int onepass_bk() { return D == 256 ? 64 : 128; }
constexpr float NEG_INF = -1e30f;

// The tiles at head dim D: M rows, a row stride of LP in an M x M score
// tile, R rows (and R score columns) of a tile per thread.
template <int D>
struct Tile {
  static constexpr int M = D > 128 ? 32 : 64;
  static constexpr int LP = M + 1;
  static constexpr int R = M / 16;
  static constexpr int floats = M * (D + 1);  // an M x D tile, stride D + 1
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back: the plain versions' .to(dtype) before a product.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ bool keep(int row, int col, int S, bool causal) {
  return row < S && col < S && (!causal || col <= row);
}

// Reductions over the 16 threads (one half warp) that share a tile row.
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + M) of columns [c0, c0 + D) of an (S, W) matrix into
// shared memory as f32, row stride D + 1; rows at or past S read 0.
template <typename T, int D>
__device__ void load_rows(float* dst, const T* src, int r0, int S, int W,
                          int c0) {
  for (int idx = threadIdx.x; idx < Tile<D>::M * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] =
        r0 + r < S ? to_f(src[(size_t)(r0 + r) * W + c0 + c]) : 0.f;
  }
}

// c[i][j] += sum_d a[ty + 16i][d] * b[tx + 16j][d]: this thread's part of
// the M x M tile A B^T, A and B M x D in shared memory.
template <int D>
__device__ void tile_abt(const float* a, const float* b,
                         float c[Tile<D>::R][Tile<D>::R]) {
  constexpr int R = Tile<D>::R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < R; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// acc[i][j] += sum_t p[ty + 16i][t] * m[t][tx + 16j]: p an M x M tile (row
// stride LP; read as its transpose, p[t][ty + 16i], when TRANS), m M x D.
template <int D, bool TRANS = false>
__device__ void tile_pm(const float* p, const float* m,
                        float acc[Tile<D>::R][D / 16]) {
  constexpr int R = Tile<D>::R, LP = Tile<D>::LP;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int t = 0; t < Tile<D>::M; ++t) {
    float pv[R], mv[D / 16];
#pragma unroll
    for (int i = 0; i < R; ++i)
      pv[i] = TRANS ? p[t * LP + ty + 16 * i] : p[(ty + 16 * i) * LP + t];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) mv[j] = m[t * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pv[i], mv[j], acc[i][j]);
  }
}

template <int A, int B>
__device__ __forceinline__ void zero(float x[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) x[i][j] = 0.f;
}

// ---------------------------------------------------------------------------
// forward: grid (BH, ceil(S / M), W / D), one M-row q tile and one D-column
// panel of o a block
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_smem() {
  return (3 * Tile<D>::floats + Tile<D>::M * Tile<D>::LP) * sizeof(float);
}

template <typename T, int D, bool CAUSAL, bool PANELS>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int S, int W) {
  constexpr int M = Tile<D>::M, LP = Tile<D>::LP, R = Tile<D>::R;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Tile<D>::floats;
  float* Vs = Ks + Tile<D>::floats;
  float* Ps = Vs + Tile<D>::floats;
  const int bh = blockIdx.x, q0 = blockIdx.y * M;
  if constexpr (!PANELS) W = D;  // one panel: the width, known here
  const int np = W / D, c0 = PANELS ? blockIdx.z * D : 0;  // this block's
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * S * W;
  // k rows any row of this tile keeps
  const int tiles = ((CAUSAL ? min(S, q0 + M) : S) + M - 1) / M;
  // One panel: Q stays in shared memory for the whole block.
  if (np == 1) load_rows<T, D>(Qs, q + base, q0, S, W, 0);

  float m[R], s[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = NEG_INF;
  for (int t = 0; t < tiles; ++t) {  // pass 1: each row's max
    zero<R, R>(s);
    for (int p = 0; p < np; ++p) {  // S = Q K^T over every panel
      __syncthreads();
      if (np > 1) load_rows<T, D>(Qs, q + base, q0, S, W, p * D);
      load_rows<T, D>(Ks, k + base, t * M, S, W, p * D);
      __syncthreads();
      tile_abt<D>(Qs, Ks, s);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (keep(q0 + ty + 16 * i, t * M + tx + 16 * j, S, CAUSAL))
          m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = row_max(m[i]);

  float l[R], acc[R][D / 16];
#pragma unroll
  for (int i = 0; i < R; ++i) l[i] = 0.f;
  zero<R, D / 16>(acc);
  for (int t = 0; t < tiles; ++t) {  // pass 2: P at the final max, PV, sum
    zero<R, R>(s);
    for (int p = 0; p < np; ++p) {  // S again, V's panel with the last
      __syncthreads();
      if (np > 1) load_rows<T, D>(Qs, q + base, q0, S, W, p * D);
      load_rows<T, D>(Ks, k + base, t * M, S, W, p * D);
      if (p + 1 == np) load_rows<T, D>(Vs, v + base, t * M, S, W, c0);
      __syncthreads();
      tile_abt<D>(Qs, Ks, s);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = keep(q0 + ty + 16 * i, t * M + tx + 16 * j, S, CAUSAL)
                            ? expf(s[i][j] - m[i]) : 0.f;
        l[i] += p;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = rnd<T>(p);
      }
    __syncthreads();
    tile_pm<D>(Ps, Vs, acc);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    const float li = fmaxf(row_sum(l[i]), 1e-30f);
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      o[base + (size_t)row * W + c0 + tx + 16 * j] = from_f<T>(acc[i][j] / li);
    if (tx == 0 && c0 == 0) lse[(size_t)bh * S + row] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// dq: grid (BH, ceil(S / M), W / D), one M-row q tile and one D-column panel
// of dq a block
// ---------------------------------------------------------------------------

template <int D> constexpr size_t dq_smem() {
  return (4 * Tile<D>::floats + Tile<D>::M * Tile<D>::LP) * sizeof(float);
}

template <typename T, int D, bool CAUSAL, bool PANELS>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ g,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int W) {
  constexpr int M = Tile<D>::M, LP = Tile<D>::LP, R = Tile<D>::R;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + Tile<D>::floats;
  float* Ks = Gs + Tile<D>::floats;
  float* Vs = Ks + Tile<D>::floats;
  float* DSs = Vs + Tile<D>::floats;
  const int bh = blockIdx.x, q0 = blockIdx.y * M;
  if constexpr (!PANELS) W = D;
  const int np = W / D, c0 = PANELS ? blockIdx.z * D : 0;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * S * W;
  const int tiles = ((CAUSAL ? min(S, q0 + M) : S) + M - 1) / M;
  if (np == 1) {
    load_rows<T, D>(Qs, q + base, q0, S, W, 0);
    load_rows<T, D>(Gs, g + base, q0, S, W, 0);
  }
  float L[R], DL[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    L[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    DL[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float s[R][R], dp[R][R], acc[R][D / 16];
  zero<R, D / 16>(acc);
  for (int t = 0; t < tiles; ++t) {
    zero<R, R>(s);
    zero<R, R>(dp);
    for (int p = 0; p < np; ++p) {  // S = Q K^T, dP = dO V^T over every panel
      __syncthreads();
      if (np > 1) {
        load_rows<T, D>(Qs, q + base, q0, S, W, p * D);
        load_rows<T, D>(Gs, g + base, q0, S, W, p * D);
      }
      load_rows<T, D>(Ks, k + base, t * M, S, W, p * D);
      load_rows<T, D>(Vs, v + base, t * M, S, W, p * D);
      __syncthreads();
      tile_abt<D>(Qs, Ks, s);
      tile_abt<D>(Gs, Vs, dp);
    }
    if (np > 1) {  // dS K takes K's columns of this block's panel
      __syncthreads();
      load_rows<T, D>(Ks, k + base, t * M, S, W, c0);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = keep(q0 + ty + 16 * i, t * M + tx + 16 * j, S, CAUSAL)
                            ? expf(s[i][j] - L[i]) : 0.f;
        DSs[(ty + 16 * i) * LP + tx + 16 * j] = rnd<T>(p * (dp[i][j] - DL[i]));
      }
    __syncthreads();
    tile_pm<D>(DSs, Ks, acc);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[base + (size_t)row * W + c0 + tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// dk/dv, and the one-pass backward: one M-row k tile at a time, one D-column
// panel of the outputs a block
// ---------------------------------------------------------------------------

template <int D> constexpr size_t kv_smem() {
  return (4 * Tile<D>::floats + 2 * Tile<D>::M * Tile<D>::LP + 2 * Tile<D>::M) *
         sizeof(float);
}

// dk and dv of k rows [k0, k0 + M), columns [c0, c0 + D) with c0 =
// blockIdx.z D; with ONEPASS also this tile's part of the dq partial of
// each q tile in those columns, into `slot` ((S, W) f32): stored when
// `add` is false, added to what the same thread stored there before when
// it is true.
template <typename T, int D, bool CAUSAL, bool PANELS, bool ONEPASS>
__device__ void kv_rows(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ slot, bool add,
                        int k0, int S, int W, float* smem) {
  constexpr int M = Tile<D>::M, LP = Tile<D>::LP, R = Tile<D>::R;
  float* Ks = smem;
  float* Vs = Ks + Tile<D>::floats;
  float* Qs = Vs + Tile<D>::floats;
  float* Gs = Qs + Tile<D>::floats;
  float* PTs = Gs + Tile<D>::floats;  // P^T: [k row][q row]
  float* DSTs = PTs + M * LP;         // dS^T
  float* Ls = DSTs + M * LP;
  float* DLs = Ls + M;
  const int bh = blockIdx.x;
  if constexpr (!PANELS) W = D;
  const int np = W / D, c0 = PANELS ? blockIdx.z * D : 0;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * S * W;
  const int nq = (S + M - 1) / M;
  __syncthreads();
  if (np == 1) {
    load_rows<T, D>(Ks, k + base, k0, S, W, 0);
    load_rows<T, D>(Vs, v + base, k0, S, W, 0);
  }
  float st[R][R], dpt[R][R], dk_acc[R][D / 16], dv_acc[R][D / 16];
  zero<R, D / 16>(dk_acc);
  zero<R, D / 16>(dv_acc);
  // Under the causal mask no q row before k0 sees these keys.
  for (int t = CAUSAL ? k0 / M : 0; t < nq; ++t) {
    const int q0 = t * M;
    zero<R, R>(st);
    zero<R, R>(dpt);
    for (int p = 0; p < np; ++p) {  // S^T = K Q^T, dP^T = V dO^T, every panel
      __syncthreads();
      if (np > 1) {
        load_rows<T, D>(Ks, k + base, k0, S, W, p * D);
        load_rows<T, D>(Vs, v + base, k0, S, W, p * D);
      }
      load_rows<T, D>(Qs, q + base, q0, S, W, p * D);
      load_rows<T, D>(Gs, g + base, q0, S, W, p * D);
      if (p == 0 && threadIdx.x < M) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] : 0.f;
        DLs[threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.f;
      }
      __syncthreads();
      tile_abt<D>(Ks, Qs, st);  // S^T: rows k (ty + 16a), cols q (tx + 16b)
      tile_abt<D>(Vs, Gs, dpt);
    }
    if (np > 1) {  // the products below take this block's panel
      __syncthreads();
      load_rows<T, D>(Qs, q + base, q0, S, W, c0);
      load_rows<T, D>(Gs, g + base, q0, S, W, c0);
      if (ONEPASS) load_rows<T, D>(Ks, k + base, k0, S, W, c0);
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int qi = tx + 16 * b;
        const float p = keep(q0 + qi, k0 + ty + 16 * a, S, CAUSAL)
                            ? expf(st[a][b] - Ls[qi]) : 0.f;
        PTs[(ty + 16 * a) * LP + qi] = rnd<T>(p);
        DSTs[(ty + 16 * a) * LP + qi] = rnd<T>(p * (dpt[a][b] - DLs[qi]));
      }
    __syncthreads();
    tile_pm<D>(PTs, Gs, dv_acc);
    tile_pm<D>(DSTs, Qs, dk_acc);
    if constexpr (ONEPASS) {
      float pc[R][D / 16];
      zero<R, D / 16>(pc);
      tile_pm<D, true>(DSTs, Ks, pc);  // rows q (ty + 16a), cols d
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int row = q0 + ty + 16 * a;
        if (row >= S) continue;
#pragma unroll
        for (int b = 0; b < D / 16; ++b) {
          float* dst = slot + (size_t)row * W + c0 + tx + 16 * b;
          *dst = add ? *dst + pc[a][b] : pc[a][b];
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row >= S) continue;
#pragma unroll
    for (int b = 0; b < D / 16; ++b) {
      dk[base + (size_t)row * W + c0 + tx + 16 * b] = from_f<T>(dk_acc[a][b]);
      dv[base + (size_t)row * W + c0 + tx + 16 * b] = from_f<T>(dv_acc[a][b]);
    }
  }
}

// grid (BH, ceil(S / M), W / D)
template <typename T, int D, bool CAUSAL, bool PANELS>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ g,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int S, int W) {
  extern __shared__ float smem[];
  kv_rows<T, D, CAUSAL, PANELS, false>(q, k, v, g, lse, delta, dk, dv, nullptr,
                                       false, blockIdx.y * Tile<D>::M, S, W,
                                       smem);
}

// grid (BH, ceil(S / BK), W / D), BK = onepass_bk<D>(): block y owns dq
// partial slot y, k rows [BK y, BK y + BK), as BK / M tiles of M rows, one
// after the other.
template <typename T, int D, bool CAUSAL, bool PANELS>
__global__ void __launch_bounds__(NT)
onepass_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dqp, T* __restrict__ dk,
               T* __restrict__ dv, int S, int W) {
  constexpr int M = Tile<D>::M, BK = onepass_bk<D>(), parts = BK / M;
  extern __shared__ float smem[];
  if constexpr (!PANELS) W = D;
  const int k0 = blockIdx.y * BK, c0 = PANELS ? blockIdx.z * D : 0;
  float* slot = dqp + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * S * W;
  if (CAUSAL)  // q rows before k0: the mask kills the whole slot there
    for (size_t i = threadIdx.x; i < (size_t)k0 * D; i += NT)
      slot[i / D * W + c0 + i % D] = 0.f;
  // The first tile stores every live q row of the slot (those from k0 on
  // under the causal mask); each later tile adds to those rows.
  for (int h = 0; h < parts && k0 + h * M < S; ++h)
    kv_rows<T, D, CAUSAL, PANELS, true>(q, k, v, g, lse, delta, dk, dv, slot,
                                        h > 0, k0 + h * M, S, W, smem);
}

template <typename Kern, typename... Args>
int launch(Kern kernel, dim3 grid, size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// (BH, blocks of `rows` rows over S, panels of D columns over W)
template <int D> dim3 grid(int bh, int s, int w, int rows = Tile<D>::M) {
  return dim3(bh, (s + rows - 1) / rows, w / D);
}

template <typename T, int D, bool C, bool P>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int bh, int s, int w, cudaStream_t st) {
  return launch(fwd_kernel<T, D, C, P>, grid<D>(bh, s, w), fwd_smem<D>(), st,
                (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, s,
                w);
}

template <typename T, int D, bool C, bool P>
int dq(const void* q, const void* k, const void* v, const void* g,
       const void* lse, const void* delta, void* out, int bh, int s, int w,
       cudaStream_t st) {
  return launch(dq_kernel<T, D, C, P>, grid<D>(bh, s, w), dq_smem<D>(), st,
                (const T*)q, (const T*)k, (const T*)v, (const T*)g,
                (const float*)lse, (const float*)delta, (float*)out, s, w);
}

template <typename T, int D, bool C, bool P>
int dkv(const void* q, const void* k, const void* v, const void* g,
        const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
        int w, cudaStream_t st) {
  return launch(dkv_kernel<T, D, C, P>, grid<D>(bh, s, w), kv_smem<D>(), st,
                (const T*)q, (const T*)k, (const T*)v, (const T*)g,
                (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, s, w);
}

template <typename T, int D, bool C, bool P>
int onepass(const void* q, const void* k, const void* v, const void* g,
            const void* lse, const void* delta, void* dqp, void* dk, void* dv,
            int bh, int s, int w, cudaStream_t st) {
  return launch(onepass_kernel<T, D, C, P>, grid<D>(bh, s, w, onepass_bk<D>()),
                kv_smem<D>(), st, (const T*)q, (const T*)k, (const T*)v,
                (const T*)g, (const float*)lse, (const float*)delta,
                (float*)dqp, (T*)dk, (T*)dv, s, w);
}

}  // namespace hvdsimt

// dtype: 0 float32, 1 float16, 2 bfloat16.  d: 32, 64, 128, 256, or a
// multiple of 128 past 256 (then the instances with PANELS: d / 128
// panels of 128 columns).  Every entry returns a cudaError_t
// (cudaErrorInvalidValue for a dtype, d or block_k it does not take).
#define HVD_SIMT_CAUSAL(FN, T, DD, P, ...)              \
  (c ? FN<T, DD, true, P>(__VA_ARGS__, d, st)          \
     : FN<T, DD, false, P>(__VA_ARGS__, d, st))
#define HVD_SIMT_WIDTHS(FN, T, ...)                                   \
  switch (d) {                                                        \
    case 32: return HVD_SIMT_CAUSAL(FN, T, 32, false, __VA_ARGS__);   \
    case 64: return HVD_SIMT_CAUSAL(FN, T, 64, false, __VA_ARGS__);   \
    case 128: return HVD_SIMT_CAUSAL(FN, T, 128, false, __VA_ARGS__); \
    case 256: return HVD_SIMT_CAUSAL(FN, T, 256, false, __VA_ARGS__); \
    default:                                                          \
      return d > 256 && d % 128 == 0                                  \
                 ? HVD_SIMT_CAUSAL(FN, T, 128, true, __VA_ARGS__)     \
                 : (int)cudaErrorInvalidValue;                        \
  }
#define HVD_SIMT_DISPATCH(FN, ...)                                        \
  do {                                                                    \
    using namespace hvdsimt;                                              \
    auto st = static_cast<cudaStream_t>(stream);                          \
    const bool c = causal != 0;                                           \
    switch (dtype) {                                                      \
      case 0: HVD_SIMT_WIDTHS(FN, float, __VA_ARGS__)                     \
      case 1: HVD_SIMT_WIDTHS(FN, __half, __VA_ARGS__)                    \
      case 2: HVD_SIMT_WIDTHS(FN, __nv_bfloat16, __VA_ARGS__)             \
      default: return (int)cudaErrorInvalidValue;                         \
    }                                                                     \
  } while (0)

extern "C" int hvd_simt_flash_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int s, int d,
                                  int causal, int dtype, void* stream) {
  HVD_SIMT_DISPATCH(fwd, q, k, v, o, lse, bh, s);
}

extern "C" int hvd_simt_flash_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* g,
                                     const void* lse, const void* delta,
                                     void* dq_out, int bh, int s, int d,
                                     int causal, int dtype, void* stream) {
  HVD_SIMT_DISPATCH(dq, q, k, v, g, lse, delta, dq_out, bh, s);
}

extern "C" int hvd_simt_flash_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int bh, int s, int d,
                                      int causal, int dtype, void* stream) {
  HVD_SIMT_DISPATCH(dkv, q, k, v, g, lse, delta, dk, dv, bh, s);
}

extern "C" int hvd_simt_flash_bwd_onepass(const void* q, const void* k,
                                          const void* v, const void* g,
                                          const void* lse, const void* delta,
                                          void* dqp, void* dk, void* dv,
                                          int bh, int s, int d, int causal,
                                          int block_k, int dtype,
                                          void* stream) {
  // the caller allocates one partial slot per block_k rows of k
  const int slot = d == 256 ? hvdsimt::onepass_bk<256>() : hvdsimt::onepass_bk<128>();
  if (block_k != slot) return (int)cudaErrorInvalidValue;
  HVD_SIMT_DISPATCH(onepass, q, k, v, g, lse, delta, dqp, dk, dv, bh, s);
}
