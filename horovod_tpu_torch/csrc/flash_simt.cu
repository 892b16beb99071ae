// Flash attention in float32 and float16 on the CUDA cores (sm_90a): the
// four flash kernels of flash_fwd.cu, flash_bwd.cu and flash_bwd_onepass.cu,
// whose Hopper versions take bf16 only, for the other two dtypes the JAX
// package's kernels take.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_attn_kernel (via
// _flash_attention_fwd_flat), _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel
// (via _flash_attention_bwd_flat) and _flash_bwd_onepass_kernel (via
// _flash_attention_bwd_onepass_flat), at f32 and f16 inputs.  Same functions
// and casts as those and as the bf16 kernels: products of inputs in T with
// f32 accumulation; P is cast to V's dtype before PV, dS to K's (dq and the
// dq partials) and Q's (dk) before its products, P to dO's before dv;
// masked scores are dropped (the TPU kernels' -1e30, whose exp is 0); lse
// and delta are f32 (BH, S) rows.  Under f32 every cast is the identity.
// Outputs: O in T and the f32 row log-sum-exp (natural log); dq f32 in the
// pre-scaled units; dk, dv in T; the one-pass kernel's dq partials f32, one
// (S, D) slot per 128 rows of k, a slot the causal mask kills all zeros.
//
// Bound on the H100 SXM: operations.  Exact f32 products are not tensor-core
// work (TF32 keeps about three decimal digits and would no longer compute
// the f32 function), so f32 is held to the 67 TFLOP/s of the CUDA cores: at
// the decoder's shape (BH 32, S 2048, D 128, causal) the forward's 34.4
// GFLOP take 0.51 ms, against 134 MB of f32 tensors (0.04 ms at 3.35 TB/s).
// f16 runs the same CUDA-core code, so its bound against the card's f16
// tensor-core peak is far below what this design can reach.
//
// Design: simple and tiled, on purpose.  No wgmma and no TMA.  A block of
// 256 threads owns 64 rows (of q for the forward and dq, of k for dk/dv);
// tiles of 64 rows live in shared memory as f32 with a row stride of D + 1
// (odd, so that a column walk hits 32 banks); each thread holds a 4 x 4
// block of a 64 x 64 score tile, and a 4 x D/16 block of a 64 x D output, in
// registers.  The forward takes two passes over the k tiles: the first finds
// each row's max, the second forms P = exp(S - max) with that final max,
// casts it to T, and accumulates PV and the row sum.  An online softmax
// would cast P at a running max and so round it at other places than the
// plain version does; with the final max, the kernel and its plain version
// cast the same values and differ only by the order of f32 sums, which
// lets the check on the card see a missing cast.  The price is S = Q K^T
// computed twice.  The one-pass kernel's block owns a 128-row k tile, the
// dq partial slot's rows, as two 64-row halves one after the other: the
// first writes each q tile's partial, the second adds its own to it (the
// same thread, the same element), so no atomics and a fixed order.
//
// Left on the table: register tiles fed by vector loads from shared
// memory, more blocks per SM at D 128, an online softmax (one pass) once a
// tolerance for it is set, and tensor cores for f16.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace hvdsimt {

constexpr int BM = 64;        // rows of a q or k tile
constexpr int NT = 256;       // threads a block: 16 x 16, each 4 rows x 4 (or D/16) cols
constexpr int LP = BM + 1;    // row stride of a 64 x 64 tile in shared memory
constexpr int ONEPASS_BK = 128;  // rows of k per dq partial slot
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
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

// Rows [r0, r0 + 64) of an (S, D) matrix into shared memory as f32, row
// stride D + 1; rows at or past S read 0.
template <typename T, int D>
__device__ void load_rows(float* dst, const T* src, int r0, int S) {
  for (int idx = threadIdx.x; idx < BM * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r0 + r < S ? to_f(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// c[i][j] = sum_d a[ty + 16i][d] * b[tx + 16j][d]: this thread's part of the
// 64 x 64 tile A B^T, A and B 64 x D in shared memory.
template <int D>
__device__ void tile_abt(const float* a, const float* b, float c[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// acc[i][j] += sum_t p[ty + 16i][t] * m[t][tx + 16j]: p a 64 x 64 tile (row
// stride LP; read as its transpose, p[t][ty + 16i], when TRANS), m 64 x D.
template <int D, bool TRANS = false>
__device__ void tile_pm(const float* p, const float* m, float acc[4][D / 16]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int t = 0; t < BM; ++t) {
    float pv[4], mv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = TRANS ? p[t * LP + ty + 16 * i] : p[(ty + 16 * i) * LP + t];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) mv[j] = m[t * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pv[i], mv[j], acc[i][j]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float acc[4][D / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
}

template <int D> __host__ __device__ constexpr int tile_floats() {
  return BM * (D + 1);
}

// ---------------------------------------------------------------------------
// forward: grid (BH, ceil(S / 64)), one 64-row q tile a block
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_smem() {
  return (3 * tile_floats<D>() + BM * LP) * sizeof(float);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int S) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + tile_floats<D>();
  float* Vs = Ks + tile_floats<D>();
  float* Ps = Vs + tile_floats<D>();
  const int bh = blockIdx.x, q0 = blockIdx.y * BM;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * S * D;
  // k rows any row of this tile keeps
  const int tiles = ((CAUSAL ? min(S, q0 + BM) : S) + BM - 1) / BM;
  load_rows<T, D>(Qs, q + base, q0, S);

  float m[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = NEG_INF;
  for (int t = 0; t < tiles; ++t) {  // pass 1: each row's max
    __syncthreads();
    load_rows<T, D>(Ks, k + base, t * BM, S);
    __syncthreads();
    tile_abt<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (keep(q0 + ty + 16 * i, t * BM + tx + 16 * j, S, CAUSAL))
          m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = row_max(m[i]);

  float l[4] = {0.f, 0.f, 0.f, 0.f}, acc[4][D / 16];
  zero<D>(acc);
  for (int t = 0; t < tiles; ++t) {  // pass 2: P at the final max, PV, sum
    __syncthreads();
    load_rows<T, D>(Ks, k + base, t * BM, S);
    load_rows<T, D>(Vs, v + base, t * BM, S);
    __syncthreads();
    tile_abt<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep(q0 + ty + 16 * i, t * BM + tx + 16 * j, S, CAUSAL)
                            ? expf(s[i][j] - m[i]) : 0.f;
        l[i] += p;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = rnd<T>(p);
      }
    __syncthreads();
    tile_pm<D>(Ps, Vs, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
// dq: grid (BH, ceil(S / 64)), one 64-row q tile a block
// ---------------------------------------------------------------------------

template <int D> constexpr size_t dq_smem() {
  return (4 * tile_floats<D>() + BM * LP) * sizeof(float);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ g,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + tile_floats<D>();
  float* Ks = Gs + tile_floats<D>();
  float* Vs = Ks + tile_floats<D>();
  float* DSs = Vs + tile_floats<D>();
  const int bh = blockIdx.x, q0 = blockIdx.y * BM;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * S * D;
  const int tiles = ((CAUSAL ? min(S, q0 + BM) : S) + BM - 1) / BM;
  load_rows<T, D>(Qs, q + base, q0, S);
  load_rows<T, D>(Gs, g + base, q0, S);
  float L[4], DL[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    L[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    DL[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float s[4][4], dp[4][4], acc[4][D / 16];
  zero<D>(acc);
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();
    load_rows<T, D>(Ks, k + base, t * BM, S);
    load_rows<T, D>(Vs, v + base, t * BM, S);
    __syncthreads();
    tile_abt<D>(Qs, Ks, s);
    tile_abt<D>(Gs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep(q0 + ty + 16 * i, t * BM + tx + 16 * j, S, CAUSAL)
                            ? expf(s[i][j] - L[i]) : 0.f;
        DSs[(ty + 16 * i) * LP + tx + 16 * j] = rnd<T>(p * (dp[i][j] - DL[i]));
      }
    __syncthreads();
    tile_pm<D>(DSs, Ks, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[base + (size_t)row * D + tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// dk/dv, and the one-pass backward: one 64-row k tile at a time
// ---------------------------------------------------------------------------

template <int D> constexpr size_t kv_smem() {
  return (4 * tile_floats<D>() + 2 * BM * LP + 2 * BM) * sizeof(float);
}

// dk and dv of k rows [k0, k0 + 64); with ONEPASS also this tile's part of
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
  float* Ks = smem;
  float* Vs = Ks + tile_floats<D>();
  float* Qs = Vs + tile_floats<D>();
  float* Gs = Qs + tile_floats<D>();
  float* PTs = Gs + tile_floats<D>();  // P^T: [k row][q row]
  float* DSTs = PTs + BM * LP;         // dS^T
  float* Ls = DSTs + BM * LP;
  float* DLs = Ls + BM;
  const int bh = blockIdx.x;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = (size_t)bh * S * D;
  const int nq = (S + BM - 1) / BM;
  __syncthreads();
  load_rows<T, D>(Ks, k + base, k0, S);
  load_rows<T, D>(Vs, v + base, k0, S);
  float st[4][4], dpt[4][4], dk_acc[4][D / 16], dv_acc[4][D / 16];
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  // Under the causal mask no q row before k0 sees these keys.
  for (int t = CAUSAL ? k0 / BM : 0; t < nq; ++t) {
    const int q0 = t * BM;
    __syncthreads();
    load_rows<T, D>(Qs, q + base, q0, S);
    load_rows<T, D>(Gs, g + base, q0, S);
    if (threadIdx.x < BM) {
      const int row = q0 + threadIdx.x;
      Ls[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      DLs[threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();
    tile_abt<D>(Ks, Qs, st);  // S^T: rows k (ty + 16a), cols q (tx + 16b)
    tile_abt<D>(Vs, Gs, dpt);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
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
      float pc[4][D / 16];
      zero<D>(pc);
      tile_pm<D, true>(DSTs, Ks, pc);  // rows q (ty + 16a), cols d
#pragma unroll
      for (int a = 0; a < 4; ++a) {
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
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row >= S) continue;
#pragma unroll
    for (int b = 0; b < D / 16; ++b) {
      dk[base + (size_t)row * D + tx + 16 * b] = from_f<T>(dk_acc[a][b]);
      dv[base + (size_t)row * D + tx + 16 * b] = from_f<T>(dv_acc[a][b]);
    }
  }
}

// grid (BH, ceil(S / 64))
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ g,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int S) {
  extern __shared__ float smem[];
  kv_rows<T, D, CAUSAL, false>(q, k, v, g, lse, delta, dk, dv, nullptr, false,
                               blockIdx.y * BM, S, smem);
}

// grid (BH, ceil(S / 128)): block y owns dq partial slot y, k rows [128y,
// 128y + 128), as two 64-row halves.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(NT)
onepass_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dqp, T* __restrict__ dk,
               T* __restrict__ dv, int S) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.y * ONEPASS_BK;
  float* slot = dqp + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * S * D;
  if (CAUSAL)  // q rows before k0: the mask kills the whole slot there
    for (size_t i = threadIdx.x; i < (size_t)k0 * D; i += NT) slot[i] = 0.f;
  kv_rows<T, D, CAUSAL, true>(q, k, v, g, lse, delta, dk, dv, slot, false, k0,
                              S, smem);
  if (k0 + BM < S)
    kv_rows<T, D, CAUSAL, true>(q, k, v, g, lse, delta, dk, dv, slot, true,
                                k0 + BM, S, smem);
}

template <typename Kern, typename... Args>
int launch(Kern kernel, dim3 grid, size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool C>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int bh, int s, cudaStream_t st) {
  return launch(fwd_kernel<T, D, C>, dim3(bh, (s + BM - 1) / BM), fwd_smem<D>(),
                st, (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
                s);
}

template <typename T, int D, bool C>
int dq(const void* q, const void* k, const void* v, const void* g,
       const void* lse, const void* delta, void* out, int bh, int s,
       cudaStream_t st) {
  return launch(dq_kernel<T, D, C>, dim3(bh, (s + BM - 1) / BM), dq_smem<D>(),
                st, (const T*)q, (const T*)k, (const T*)v, (const T*)g,
                (const float*)lse, (const float*)delta, (float*)out, s);
}

template <typename T, int D, bool C>
int dkv(const void* q, const void* k, const void* v, const void* g,
        const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
        cudaStream_t st) {
  return launch(dkv_kernel<T, D, C>, dim3(bh, (s + BM - 1) / BM), kv_smem<D>(),
                st, (const T*)q, (const T*)k, (const T*)v, (const T*)g,
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

// dtype: 0 float32, 1 float16.  d: 32, 64 or 128.  Every entry returns a
// cudaError_t (cudaErrorInvalidValue for a dtype, d or block_k it does not
// take).
#define HVD_SIMT_DISPATCH(FN, ...)                                            \
  do {                                                                        \
    using namespace hvdsimt;                                                  \
    auto st = static_cast<cudaStream_t>(stream);                              \
    const bool c = causal != 0;                                               \
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;          \
    switch (d) {                                                              \
      case 32:                                                                \
        return dtype == 0                                                     \
            ? (c ? FN<float, 32, true>(__VA_ARGS__, st)                       \
                 : FN<float, 32, false>(__VA_ARGS__, st))                     \
            : (c ? FN<__half, 32, true>(__VA_ARGS__, st)                      \
                 : FN<__half, 32, false>(__VA_ARGS__, st));                   \
      case 64:                                                                \
        return dtype == 0                                                     \
            ? (c ? FN<float, 64, true>(__VA_ARGS__, st)                       \
                 : FN<float, 64, false>(__VA_ARGS__, st))                     \
            : (c ? FN<__half, 64, true>(__VA_ARGS__, st)                      \
                 : FN<__half, 64, false>(__VA_ARGS__, st));                   \
      case 128:                                                               \
        return dtype == 0                                                     \
            ? (c ? FN<float, 128, true>(__VA_ARGS__, st)                      \
                 : FN<float, 128, false>(__VA_ARGS__, st))                    \
            : (c ? FN<__half, 128, true>(__VA_ARGS__, st)                     \
                 : FN<__half, 128, false>(__VA_ARGS__, st));                  \
      default:                                                                \
        return (int)cudaErrorInvalidValue;                                    \
    }                                                                         \
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
