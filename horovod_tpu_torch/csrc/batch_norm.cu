// Fused train-mode BatchNorm (+ residual add) (+ ReLU) for Hopper (sm_90a).
//
// Replaces: horovod_tpu/ops/pallas_bn.py, the four kernels behind
// batch_norm_act:
//   _stats_kernel    -> bn_stats_partial_kernel + bn_stats_finish_kernel
//   _apply_kernel    -> bn_apply_kernel
//   _bwd_red_kernel  -> bn_bwd_red_partial_kernel + bn_bwd_red_finish_kernel
//   _bwd_dx_kernel   -> bn_bwd_dx_kernel
// Same functions, on the (M, C) view of a channels-last activation: per-
// channel sums of x and x*x in f32 (stats); (x - mean) * (rinv * gamma) +
// beta, + residual, ReLU, cast to x's type (apply); dbeta = sum dy_eff and
// dgamma = sum dy_eff * xhat from one read, the ReLU mask recomputed from x
// and the residual (bwd_red); dx = gamma * rinv * (dy_eff - dbeta/M -
// xhat * dgamma/M) and dres = dy_eff (bwd_dx).  x, dy and the residual are
// bf16 or f32; mean, var, gamma, beta, dbeta and dgamma are f32 [C].
//
// Bound on the H100 SXM: bytes.  A few operations per element against 2
// bytes (bf16) per element read or written: far below the ~20 FLOP/byte at
// which the f32 units would be the limit.  For ResNet-50 at batch 128, 224^2
// the 53 NormActs of a step move 2.85 GB (stats), 7.10 GB (apply), 7.10 GB
// (bwd_red) and 11.36 GB (bwd_dx): 0.85, 2.12, 2.12 and 3.39 ms at 3.35 TB/s.
//
// Design: the TPU grid walked M in order for each channel tile and carried
// the sums in VMEM scratch.  Here a block of 32 x 8 threads owns a tile of
// 32 * VEC channels and a chunk of rows: lane x reads VEC neighbouring
// channels of a row (bf16x2 or float2 when C is even), so a warp reads 128
// or 256 contiguous bytes of one row, and the 8 warps take every 8th row of
// the chunk.  The reductions keep f32 sums in registers, add the 8 warps'
// sums in shared memory in a fixed order and write one partial per (chunk,
// channel) to a workspace the caller allocates; a second small kernel adds
// the chunks of each channel in a fixed order.  No float atomics: results
// repeat bit for bit from run to run.  The elementwise kernels load their
// per-channel vectors once per thread and stream the rows.  Every
// elementwise operation uses the round-to-nearest intrinsics (never a
// contracted FMA), in the order the plain PyTorch versions use, so that
// y, the ReLU mask, dx and dres equal the plain versions' bit for bit on
// the same statistics.  rinv is 1 / sqrt(var + eps), both IEEE-rounded.
//
// Left on the table: wider (16-byte) loads, TMA, one pass for the two
// reductions' chunks (last block finishes), and keeping x in shared memory
// between the statistics and the apply pass for the small layers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace hvdbn {

using bf16 = __nv_bfloat16;
constexpr int TX = 32;  // lanes across channels
constexpr int TY = 8;   // warps across rows
constexpr int FIN = 256;  // threads of a finishing block, one channel each

template <class T>
struct Type {
  using type = T;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// VEC neighbouring elements of p at i, widened to f32.
template <class T, int VEC>
__device__ __forceinline__ void load(const T* __restrict__ p, size_t i,
                                     float (&v)[VEC]) {
  if constexpr (VEC == 2 && std::is_same<T, float>::value) {
    const float2 t = *reinterpret_cast<const float2*>(p + i);
    v[0] = t.x;
    v[1] = t.y;
  } else if constexpr (VEC == 2) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p + i);
    v[0] = __low2float(t);
    v[1] = __high2float(t);
  } else {
    v[0] = widen(p[i]);
  }
}

// VEC f32 values rounded to T and stored at p + i.
template <class T, int VEC>
__device__ __forceinline__ void store(T* __restrict__ p, size_t i,
                                      const float (&v)[VEC]) {
  if constexpr (VEC == 2 && std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p + i) = make_float2(v[0], v[1]);
  } else if constexpr (VEC == 2) {
    __nv_bfloat162 t;
    t.x = __float2bfloat16_rn(v[0]);
    t.y = __float2bfloat16_rn(v[1]);
    *reinterpret_cast<__nv_bfloat162*>(p + i) = t;
  } else if constexpr (std::is_same<T, float>::value) {
    p[i] = v[0];
  } else {
    p[i] = __float2bfloat16_rn(v[0]);
  }
}

__device__ __forceinline__ float rinv_of(float var, float eps) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// The sums of this block's 8 warps, in warp order, written as the chunk's
// partial: part[(chunk * 2 + 0) * C + c] and part[(chunk * 2 + 1) * C + c].
template <int VEC>
__device__ __forceinline__ void block_partial(const float (&a)[VEC],
                                              const float (&b)[VEC],
                                              float* __restrict__ part, int c,
                                              int C) {
  __shared__ float sa[TY][TX * VEC], sb[TY][TX * VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sa[threadIdx.y][threadIdx.x * VEC + j] = a[j];
    sb[threadIdx.y][threadIdx.x * VEC + j] = b[j];
  }
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  float* pa = part + (size_t)blockIdx.y * 2 * C;
  float* pb = pa + C;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < TY; ++w) {
      ta += sa[w][threadIdx.x * VEC + j];
      tb += sb[w][threadIdx.x * VEC + j];
    }
    pa[c + j] = ta;
    pb[c + j] = tb;
  }
}

// out_a[c] and out_b[c]: the chunks' partials of channel c, added in chunk
// order.
__device__ __forceinline__ void finish(const float* __restrict__ part,
                                       float* __restrict__ out_a,
                                       float* __restrict__ out_b, int chunks,
                                       int C) {
  const int c = blockIdx.x * FIN + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
#pragma unroll 8
  for (int k = 0; k < chunks; ++k) {
    a += part[(size_t)(2 * k) * C + c];
    b += part[(size_t)(2 * k + 1) * C + c];
  }
  out_a[c] = a;
  out_b[c] = b;
}

// ---------------------------------------------------------------------------
// statistics: sum x and sum x*x per channel
// ---------------------------------------------------------------------------

template <class T, int VEC>
__global__ void __launch_bounds__(TX* TY)
bn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                        int M, int C, int rows) {
  const int c = (blockIdx.x * TX + threadIdx.x) * VEC;
  const int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
  float s[VEC] = {}, q[VEC] = {};
  if (c < C) {
#pragma unroll 4
    for (int r = r0 + threadIdx.y; r < r1; r += TY) {
      float v[VEC];
      load<T, VEC>(x, (size_t)r * C + c, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[j] += v[j];
        q[j] = fmaf(v[j], v[j], q[j]);
      }
    }
  }
  block_partial<VEC>(s, q, part, c, C);
}

__global__ void __launch_bounds__(FIN)
bn_stats_finish_kernel(const float* __restrict__ part, float* __restrict__ sum,
                       float* __restrict__ sq, int chunks, int C) {
  finish(part, sum, sq, chunks, C);
}

// ---------------------------------------------------------------------------
// apply: normalize, scale and shift, + residual, ReLU
// ---------------------------------------------------------------------------

template <class T, int VEC, bool RELU, bool RES>
__global__ void __launch_bounds__(TX* TY)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ var, const float* __restrict__ gamma,
                const float* __restrict__ beta, const T* __restrict__ res,
                T* __restrict__ y, float eps, int M, int C, int rows) {
  const int c = (blockIdx.x * TX + threadIdx.x) * VEC;
  if (c >= C) return;
  float mu[VEC], k[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = mean[c + j];
    k[j] = __fmul_rn(rinv_of(var[c + j], eps), gamma[c + j]);
    b[j] = beta[c + j];
  }
  const int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
#pragma unroll 4
  for (int r = r0 + threadIdx.y; r < r1; r += TY) {
    const size_t i = (size_t)r * C + c;
    float v[VEC], rv[VEC];
    load<T, VEC>(x, i, v);
    if constexpr (RES) load<T, VEC>(res, i, rv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float z = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mu[j]), k[j]), b[j]);
      if constexpr (RES) z = __fadd_rn(z, rv[j]);
      if constexpr (RELU) z = fmaxf(z, 0.f);
      v[j] = z;
    }
    store<T, VEC>(y, i, v);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Per-channel constants of the backward kernels.
template <int VEC>
struct Chan {
  float mu[VEC], rinv[VEC], g[VEC], b[VEC];

  __device__ __forceinline__ Chan(const float* mean, const float* var,
                                  const float* gamma, const float* beta,
                                  float eps, int c) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mu[j] = mean[c + j];
      rinv[j] = rinv_of(var[c + j], eps);
      g[j] = gamma[c + j];
      b[j] = beta[c + j];
    }
  }
};

// xhat and the ReLU-masked upstream gradient of one element: the
// pre-activation is recomputed as xhat * gamma + beta (+ residual), never
// stored.
template <bool RELU, bool RES>
__device__ __forceinline__ float xhat_dy(float x, float dy, float res, float mu,
                                         float rinv, float g, float b,
                                         float& xh) {
  xh = __fmul_rn(__fsub_rn(x, mu), rinv);
  if constexpr (RELU) {
    float z = __fadd_rn(__fmul_rn(xh, g), b);
    if constexpr (RES) z = __fadd_rn(z, res);
    return z > 0.f ? dy : 0.f;
  }
  return dy;
}

template <class T, int VEC, bool RELU, bool RES>
__global__ void __launch_bounds__(TX* TY)
bn_bwd_red_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ mean,
                          const float* __restrict__ var,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const T* __restrict__ res, float* __restrict__ part,
                          float eps, int M, int C, int rows) {
  const int c = (blockIdx.x * TX + threadIdx.x) * VEC;
  const int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
  float db[VEC] = {}, dg[VEC] = {};
  if (c < C) {
    const Chan<VEC> ch(mean, var, gamma, beta, eps, c);
#pragma unroll 4
    for (int r = r0 + threadIdx.y; r < r1; r += TY) {
      const size_t i = (size_t)r * C + c;
      float v[VEC], d[VEC], rv[VEC] = {};
      load<T, VEC>(x, i, v);
      load<T, VEC>(dy, i, d);
      if constexpr (RES) load<T, VEC>(res, i, rv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float xh;
        const float de = xhat_dy<RELU, RES>(v[j], d[j], rv[j], ch.mu[j],
                                            ch.rinv[j], ch.g[j], ch.b[j], xh);
        db[j] += de;
        dg[j] = fmaf(de, xh, dg[j]);
      }
    }
  }
  block_partial<VEC>(db, dg, part, c, C);
}

__global__ void __launch_bounds__(FIN)
bn_bwd_red_finish_kernel(const float* __restrict__ part, float* __restrict__ db,
                         float* __restrict__ dg, int chunks, int C) {
  finish(part, db, dg, chunks, C);
}

template <class T, int VEC, bool RELU, bool RES>
__global__ void __launch_bounds__(TX* TY)
bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ mean, const float* __restrict__ var,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ dbeta,
                 const float* __restrict__ dgamma, const T* __restrict__ res,
                 T* __restrict__ dx, T* __restrict__ dres, float eps,
                 float inv_m, int M, int C, int rows) {
  const int c = (blockIdx.x * TX + threadIdx.x) * VEC;
  if (c >= C) return;
  const Chan<VEC> ch(mean, var, gamma, beta, eps, c);
  float k[VEC], dbm[VEC], dgm[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    k[j] = __fmul_rn(ch.g[j], ch.rinv[j]);
    dbm[j] = __fmul_rn(dbeta[c + j], inv_m);
    dgm[j] = __fmul_rn(dgamma[c + j], inv_m);
  }
  const int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
#pragma unroll 4
  for (int r = r0 + threadIdx.y; r < r1; r += TY) {
    const size_t i = (size_t)r * C + c;
    float v[VEC], d[VEC], rv[VEC] = {}, out[VEC];
    load<T, VEC>(x, i, v);
    load<T, VEC>(dy, i, d);
    if constexpr (RES) load<T, VEC>(res, i, rv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float xh;
      d[j] = xhat_dy<RELU, RES>(v[j], d[j], rv[j], ch.mu[j], ch.rinv[j],
                                ch.g[j], ch.b[j], xh);
      out[j] = __fmul_rn(
          k[j], __fsub_rn(__fsub_rn(d[j], dbm[j]), __fmul_rn(xh, dgm[j])));
    }
    store<T, VEC>(dx, i, out);
    if constexpr (RES) store<T, VEC>(dres, i, d);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Calls f(Type<T>, integral_constant VEC, bool_constant RELU, bool_constant
// RES) with the compile-time values of the run-time flags.
template <class F>
static cudaError_t dispatch(int is_bf16, int vec, bool relu, bool res, F f) {
  auto with_res = [&](auto t, auto v, auto rl) -> cudaError_t {
    return res ? f(t, v, rl, std::true_type{}) : f(t, v, rl, std::false_type{});
  };
  auto with_relu = [&](auto t, auto v) -> cudaError_t {
    return relu ? with_res(t, v, std::true_type{})
                : with_res(t, v, std::false_type{});
  };
  auto with_vec = [&](auto t) -> cudaError_t {
    return vec == 2 ? with_relu(t, std::integral_constant<int, 2>{})
                    : with_relu(t, std::integral_constant<int, 1>{});
  };
  if (vec != 1 && vec != 2) return cudaErrorInvalidValue;
  return is_bf16 ? with_vec(Type<bf16>{}) : with_vec(Type<float>{});
}

static bool bad_shape(int m, int c, int rows, int vec) {
  return m < 1 || c < 1 || rows < 1 || (vec == 2 && c % 2) ||
         (m + rows - 1) / rows > 65535;
}

static dim3 grid_of(int m, int c, int rows, int vec) {
  return dim3((c + TX * vec - 1) / (TX * vec), (m + rows - 1) / rows);
}

}  // namespace hvdbn

using hvdbn::bf16;
using hvdbn::TX;
using hvdbn::TY;

// Per-channel sums of x (M, C): sum[c], sq[c]; part is an f32 workspace of
// (ceil(M / rows), 2, C).
extern "C" int hvd_bn_stats(const void* x, void* part, void* sum, void* sq,
                            int m, int c, int rows, int is_bf16, int vec,
                            void* stream) {
  using namespace hvdbn;
  if (bad_shape(m, c, rows, vec)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(m, c, rows, vec);
  cudaError_t err = dispatch(is_bf16, vec, false, false,
                             [&](auto t, auto v, auto, auto) -> cudaError_t {
    using T = typename decltype(t)::type;
    bn_stats_partial_kernel<T, decltype(v)::value><<<grid, dim3(TX, TY), 0, st>>>(
        static_cast<const T*>(x), static_cast<float*>(part), m, c, rows);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  bn_stats_finish_kernel<<<(c + FIN - 1) / FIN, FIN, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(sum),
      static_cast<float*>(sq), (int)grid.y, c);
  return (int)cudaGetLastError();
}

// y = (x - mean) * (rinv * gamma) + beta (+ res), ReLU if relu; res may be
// null.
extern "C" int hvd_bn_apply(const void* x, const void* mean, const void* var,
                            const void* gamma, const void* beta,
                            const void* res, void* y, float eps, int m, int c,
                            int rows, int is_bf16, int vec, int relu,
                            void* stream) {
  using namespace hvdbn;
  if (bad_shape(m, c, rows, vec)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(m, c, rows, vec);
  return (int)dispatch(is_bf16, vec, relu != 0, res != nullptr,
                       [&](auto t, auto v, auto rl, auto rs) -> cudaError_t {
    using T = typename decltype(t)::type;
    bn_apply_kernel<T, decltype(v)::value, decltype(rl)::value,
                    decltype(rs)::value><<<grid, dim3(TX, TY), 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(var), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const T*>(res),
        static_cast<T*>(y), eps, m, c, rows);
    return cudaGetLastError();
  });
}

// dbeta[c] = sum dy_eff, dgamma[c] = sum dy_eff * xhat; part as for stats.
extern "C" int hvd_bn_bwd_red(const void* x, const void* dy, const void* mean,
                              const void* var, const void* gamma,
                              const void* beta, const void* res, void* part,
                              void* dbeta, void* dgamma, float eps, int m,
                              int c, int rows, int is_bf16, int vec, int relu,
                              void* stream) {
  using namespace hvdbn;
  if (bad_shape(m, c, rows, vec)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(m, c, rows, vec);
  cudaError_t err = dispatch(is_bf16, vec, relu != 0, res != nullptr,
                             [&](auto t, auto v, auto rl, auto rs) -> cudaError_t {
    using T = typename decltype(t)::type;
    bn_bwd_red_partial_kernel<T, decltype(v)::value, decltype(rl)::value,
                              decltype(rs)::value><<<grid, dim3(TX, TY), 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const float*>(mean), static_cast<const float*>(var),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const T*>(res), static_cast<float*>(part), eps, m, c, rows);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  bn_bwd_red_finish_kernel<<<(c + FIN - 1) / FIN, FIN, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dbeta),
      static_cast<float*>(dgamma), (int)grid.y, c);
  return (int)cudaGetLastError();
}

// dx = gamma * rinv * (dy_eff - dbeta * inv_m - xhat * (dgamma * inv_m)),
// dres = dy_eff; res and dres both null or both set.
extern "C" int hvd_bn_bwd_dx(const void* x, const void* dy, const void* mean,
                             const void* var, const void* gamma,
                             const void* beta, const void* dbeta,
                             const void* dgamma, const void* res, void* dx,
                             void* dres, float eps, float inv_m, int m, int c,
                             int rows, int is_bf16, int vec, int relu,
                             void* stream) {
  using namespace hvdbn;
  if (bad_shape(m, c, rows, vec) || (res == nullptr) != (dres == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(m, c, rows, vec);
  return (int)dispatch(is_bf16, vec, relu != 0, res != nullptr,
                       [&](auto t, auto v, auto rl, auto rs) -> cudaError_t {
    using T = typename decltype(t)::type;
    bn_bwd_dx_kernel<T, decltype(v)::value, decltype(rl)::value,
                     decltype(rs)::value><<<grid, dim3(TX, TY), 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const float*>(mean), static_cast<const float*>(var),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const float*>(dbeta), static_cast<const float*>(dgamma),
        static_cast<const T*>(res), static_cast<T*>(dx), static_cast<T*>(dres),
        eps, inv_m, m, c, rows);
    return cudaGetLastError();
  });
}
