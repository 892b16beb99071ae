// Flash attention in float32, float16 and bfloat16 on the CUDA cores
// (sm_90a): the four flash kernels of flash_fwd.cu, flash_bwd.cu and
// flash_bwd_onepass.cu for what the Hopper versions do not take: f32 at
// any width, f16 dq and dk/dv, and every dtype at head dim 256.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_attn_kernel (via
// _flash_attention_fwd_flat), _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel
// (via _flash_attention_bwd_flat) and _flash_bwd_onepass_kernel (via
// _flash_attention_bwd_onepass_flat), at f32, f16 and bf16 inputs and head
// dims 32, 64, 128 and 256 (the JAX package pads a head dim to a multiple
// of 128 and computes any).  Same functions and casts as those and as the
// Hopper kernels: products of inputs in T with f32 accumulation; P is cast
// to V's dtype before PV, dS to K's (dq and the dq partials) and Q's (dk)
// before its products, P to dO's before dv; masked scores are dropped (the
// TPU kernels' -1e30, whose exp is 0); lse and delta are f32 (BH, S) rows.
// Under f32 every cast is the identity.  Outputs: O in T and the f32 row
// log-sum-exp (natural log); dq f32 in the pre-scaled units; dk, dv in T;
// the one-pass kernel's dq partials f32, one (S, D) slot per 128 rows of k,
// a slot the causal mask kills all zeros.  No conversion flushes an f16
// subnormal to zero.
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
// 256 threads owns M rows (of q for the forward and dq, of k for dk/dv):
// M is 64, or 32 at D 256, where four 64-row f32 tiles of 257 floats a
// row would pass the 227 KB a block may use.  Tiles of M rows live in
// shared memory as f32 (whatever T is) with a row stride of D + 1 (odd, so
// that a column walk hits 32 banks); each thread holds an R x R block (R =
// M / 16) of an M x M score tile, and an R x D/16 block of an M x D
// output, in registers.  The forward takes two passes over the k tiles:
// the first finds each row's max, the second forms P = exp(S - max) with
// that final max, casts it to T, and accumulates PV and the row sum.  An
// online softmax would cast P at a running max and so round it at other
// places than the plain version does; with the final max, the kernel and
// its plain version cast the same values and differ only by the order of
// f32 sums, which lets the check on the card see a missing cast.  The
// price is S = Q K^T computed twice.  The one-pass kernel's block owns a
// 128-row k tile, the dq partial slot's rows, as 128 / M tiles one after
// the other: the first writes each q tile's partial, each later one adds
// its own to it (the same thread, the same element), so no atomics and a
// fixed order.
//
// Left on the table: register tiles fed by vector loads from shared
// memory, more blocks per SM at D 128, an online softmax (one pass) once a
// tolerance for it is set, tensor cores for the f16 dq and dk/dv, and a
// Hopper plan at D 256.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace hvdsimt {

constexpr int NT = 256;          // threads a block: 16 x 16
constexpr int ONEPASS_BK = 128;  // rows of k per dq partial slot
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

// Rows [r0, r0 + M) of an (S, D) matrix into shared memory as f32, row
// stride D + 1; rows at or past S read 0.
template <typename T, int D>
__device__ void load_rows(float* dst, const T* src, int r0, int S) {
  for (int idx = threadIdx.x; idx < Tile<D>::M * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r0 + r < S ? to_f(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// c[i][j] = sum_d a[ty + 16i][d] * b[tx + 16j][d]: this thread's part of the
// M x M tile A B^T, A and B M x D in shared memory.
template <int D>
__device__ void tile_abt(const float* a, const float* b,
                         float c[Tile<D>::R][Tile<D>::R]) {
  constexpr int R = Tile<D>::R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) c[i][j] = 0.f;
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

template <int D>
__device__ __forceinline__ void zero(float acc[Tile<D>::R][D / 16]) {
#pragma unroll
  for (int i = 0; i < Tile<D>::R; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------------------
// forward: grid (BH, ceil(S / M)), one M-row q tile a block
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_smem() {
  return (3 * Tile<D>::floats + Tile<D>::M * Tile<D>::LP) * sizeof(float);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int S) {
  constexpr int M = Tile<D>::M, LP = Tile<D>::LP, R = Tile<D>::R;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Tile<D>::floats;
  float* Vs = Ks + Tile<D>::floats;
  float* Ps = Vs + Tile<D>::floats;
  const int bh = blockIdx.x, q0 = blockIdx.y * M;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * S * D;
  // k rows any row of this tile keeps
  const int tiles = ((CAUSAL ? min(S, q0 + M) : S) + M - 1) / M;
  load_rows<T, D>(Qs, q + base, q0, S);

  float m[R], s[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = NEG_INF;
  for (int t = 0; t < tiles; ++t) {  // pass 1: each row's max
    __syncthreads();
    load_rows<T, D>(Ks, k + base, t * M, S);
    __syncthreads();
    tile_abt<D>(Qs, Ks, s);
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
  zero<D>(acc);
  for (int t = 0; t < tiles; ++t) {  // pass 2: P at the final max, PV, sum
    __syncthreads();
    load_rows<T, D>(Ks, k + base, t * M, S);
    load_rows<T, D>(Vs, v + base, t * M, S);
    __syncthreads();
    tile_abt<D>(Qs, Ks, s);
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
      o[base + (size_t)row * D + tx + 16 * j] = from_f<T>(acc[i][j] / li);
    if (tx == 0) lse[(size_t)bh * S + row] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// dq: grid (BH, ceil(S / M)), one M-row q tile a block
// ---------------------------------------------------------------------------

template <int D> constexpr size_t dq_smem() {
  return (4 * Tile<D>::floats + Tile<D>::M * Tile<D>::LP) * sizeof(float);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ g,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S) {
  constexpr int M = Tile<D>::M, LP = Tile<D>::LP, R = Tile<D>::R;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + Tile<D>::floats;
  float* Ks = Gs + Tile<D>::floats;
  float* Vs = Ks + Tile<D>::floats;
  float* DSs = Vs + Tile<D>::floats;
  const int bh = blockIdx.x, q0 = blockIdx.y * M;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * S * D;
  const int tiles = ((CAUSAL ? min(S, q0 + M) : S) + M - 1) / M;
  load_rows<T, D>(Qs, q + base, q0, S);
  load_rows<T, D>(Gs, g + base, q0, S);
  float L[R], DL[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    L[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    DL[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float s[R][R], dp[R][R], acc[R][D / 16];
  zero<D>(acc);
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();
    load_rows<T, D>(Ks, k + base, t * M, S);
    load_rows<T, D>(Vs, v + base, t * M, S);
    __syncthreads();
    tile_abt<D>(Qs, Ks, s);
    tile_abt<D>(Gs, Vs, dp);
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
      dq[base + (size_t)row * D + tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// dk/dv, and the one-pass backward: one M-row k tile at a time
// ---------------------------------------------------------------------------

template <int D> constexpr size_t kv_smem() {
  return (4 * Tile<D>::floats + 2 * Tile<D>::M * Tile<D>::LP + 2 * Tile<D>::M) *
         sizeof(float);
}

// dk and dv of k rows [k0, k0 + M); with ONEPASS also this tile's part of
// the dq partial of each q tile, into `slot` ((S, D) f32): stored when
// `add` is false, added to what the same thread stored there before when
// it is true.
template <typename T, int D, bool CAUSAL, bool ONEPASS>
__device__ void kv_rows(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ slot, bool add,
                        int k0, int S, float* smem) {
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
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * S * D;
  const int nq = (S + M - 1) / M;
  __syncthreads();
  load_rows<T, D>(Ks, k + base, k0, S);
  load_rows<T, D>(Vs, v + base, k0, S);
  float st[R][R], dpt[R][R], dk_acc[R][D / 16], dv_acc[R][D / 16];
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  // Under the causal mask no q row before k0 sees these keys.
  for (int t = CAUSAL ? k0 / M : 0; t < nq; ++t) {
    const int q0 = t * M;
    __syncthreads();
    load_rows<T, D>(Qs, q + base, q0, S);
    load_rows<T, D>(Gs, g + base, q0, S);
    if (threadIdx.x < M) {
      const int row = q0 + threadIdx.x;
      Ls[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      DLs[threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();
    tile_abt<D>(Ks, Qs, st);  // S^T: rows k (ty + 16a), cols q (tx + 16b)
    tile_abt<D>(Vs, Gs, dpt);
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
      zero<D>(pc);
      tile_pm<D, true>(DSTs, Ks, pc);  // rows q (ty + 16a), cols d
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int row = q0 + ty + 16 * a;
        if (row >= S) continue;
#pragma unroll
        for (int b = 0; b < D / 16; ++b) {
          float* dst = slot + (size_t)row * D + tx + 16 * b;
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
      dk[base + (size_t)row * D + tx + 16 * b] = from_f<T>(dk_acc[a][b]);
      dv[base + (size_t)row * D + tx + 16 * b] = from_f<T>(dv_acc[a][b]);
    }
  }
}

// grid (BH, ceil(S / M))
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ g,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int S) {
  extern __shared__ float smem[];
  kv_rows<T, D, CAUSAL, false>(q, k, v, g, lse, delta, dk, dv, nullptr, false,
                               blockIdx.y * Tile<D>::M, S, smem);
}

// grid (BH, ceil(S / 128)): block y owns dq partial slot y, k rows [128y,
// 128y + 128), as 128 / M tiles of M rows, one after the other.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
onepass_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dqp, T* __restrict__ dk,
               T* __restrict__ dv, int S) {
  constexpr int M = Tile<D>::M, parts = ONEPASS_BK / M;
  extern __shared__ float smem[];
  const int k0 = blockIdx.y * ONEPASS_BK;
  float* slot = dqp + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * S * D;
  if (CAUSAL)  // q rows before k0: the mask kills the whole slot there
    for (size_t i = threadIdx.x; i < (size_t)k0 * D; i += NT) slot[i] = 0.f;
  // The first tile stores every live q row of the slot (those from k0 on
  // under the causal mask); each later tile adds to those rows.
  for (int h = 0; h < parts && k0 + h * M < S; ++h)
    kv_rows<T, D, CAUSAL, true>(q, k, v, g, lse, delta, dk, dv, slot, h > 0,
                                k0 + h * M, S, smem);
}

template <typename Kern, typename... Args>
int launch(Kern kernel, dim3 grid, size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int D> dim3 row_grid(int bh, int s) {
  return dim3(bh, (s + Tile<D>::M - 1) / Tile<D>::M);
}

template <typename T, int D, bool C>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int bh, int s, cudaStream_t st) {
  return launch(fwd_kernel<T, D, C>, row_grid<D>(bh, s), fwd_smem<D>(), st,
                (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, s);
}

template <typename T, int D, bool C>
int dq(const void* q, const void* k, const void* v, const void* g,
       const void* lse, const void* delta, void* out, int bh, int s,
       cudaStream_t st) {
  return launch(dq_kernel<T, D, C>, row_grid<D>(bh, s), dq_smem<D>(), st,
                (const T*)q, (const T*)k, (const T*)v, (const T*)g,
                (const float*)lse, (const float*)delta, (float*)out, s);
}

template <typename T, int D, bool C>
int dkv(const void* q, const void* k, const void* v, const void* g,
        const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
        cudaStream_t st) {
  return launch(dkv_kernel<T, D, C>, row_grid<D>(bh, s), kv_smem<D>(), st,
                (const T*)q, (const T*)k, (const T*)v, (const T*)g,
                (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, s);
}

template <typename T, int D, bool C>
int onepass(const void* q, const void* k, const void* v, const void* g,
            const void* lse, const void* delta, void* dqp, void* dk, void* dv,
            int bh, int s, cudaStream_t st) {
  return launch(onepass_kernel<T, D, C>,
                dim3(bh, (s + ONEPASS_BK - 1) / ONEPASS_BK), kv_smem<D>(), st,
                (const T*)q, (const T*)k, (const T*)v, (const T*)g,
                (const float*)lse, (const float*)delta, (float*)dqp, (T*)dk,
                (T*)dv, s);
}

}  // namespace hvdsimt

// dtype: 0 float32, 1 float16, 2 bfloat16.  d: 32, 64, 128 or 256.  Every
// entry returns a cudaError_t (cudaErrorInvalidValue for a dtype, d or
// block_k it does not take).
#define HVD_SIMT_CAUSAL(FN, T, DD, ...) \
  (c ? FN<T, DD, true>(__VA_ARGS__, st) : FN<T, DD, false>(__VA_ARGS__, st))
#define HVD_SIMT_WIDTHS(FN, T, ...)                            \
  switch (d) {                                                 \
    case 32: return HVD_SIMT_CAUSAL(FN, T, 32, __VA_ARGS__);   \
    case 64: return HVD_SIMT_CAUSAL(FN, T, 64, __VA_ARGS__);   \
    case 128: return HVD_SIMT_CAUSAL(FN, T, 128, __VA_ARGS__); \
    case 256: return HVD_SIMT_CAUSAL(FN, T, 256, __VA_ARGS__); \
    default: return (int)cudaErrorInvalidValue;                \
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
  if (block_k != hvdsimt::ONEPASS_BK) return (int)cudaErrorInvalidValue;
  HVD_SIMT_DISPATCH(onepass, q, k, v, g, lse, delta, dqp, dk, dv, bh, s);
}
