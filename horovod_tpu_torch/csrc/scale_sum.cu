// Fused scale and sum for Hopper (sm_90a): out = alpha * a + beta * b.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py, _scale_sum_kernel (launched
// by fused_scale_sum): out[i] = cast(alpha * f32(a[i]) + beta * f32(b[i]))
// in a's type, for f32, bf16 and f16 buffers of any length.  In the port it
// is Adasum's combine, ca * a + cb * b (utils/adasum.py adasum_pair), the
// twin of upstream Horovod's ScaledAdd.
//
// Bound on the H100 SXM: bytes.  Three operations per element against 12
// (f32) or 6 (bf16, f16) bytes read and written, far below the ~20 FLOP/byte
// at which the f32 units would be the limit.  BERT-Large's word-embedding
// gradient (31,254,528 f32 values) moves 375 MB: 0.112 ms at 3.35 TB/s.
//
// Design: the TPU kernel padded the flat buffer to 4096 x 128 tiles and
// streamed them through VMEM.  Here a grid-stride loop walks 16-byte vectors
// (4 f32 or 8 bf16/f16 values a load) when a, b and out are 16-byte aligned,
// and single elements otherwise; the elements past the last whole vector
// (fewer than one vector) are done one a thread by the first threads of the
// grid, so nothing is padded or copied.  The arithmetic is two rounded
// multiplies and one rounded add (__fmul_rn, __fadd_rn): nvcc would
// otherwise contract alpha * a + beta * b into an FMA, one rounding fewer
// than the plain PyTorch version's separate multiplies and add, and the last
// bit would differ.  The coefficients come as two f32 values, or from two
// device pointers (Adasum computes them on the device; they never cross to
// the host).
//
// Left on the table: a persistent grid sized to the SMs, and fusing the
// Adasum dot products into the same pass over a and b.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace hvdss {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 8;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <class T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}

template <class T>
__device__ __forceinline__ T combine(float alpha, T a, float beta, T b) {
  return narrow<T>(
      __fadd_rn(__fmul_rn(alpha, widen(a)), __fmul_rn(beta, widen(b))));
}

template <class T, bool VEC>
__global__ void __launch_bounds__(THREADS)
scale_sum_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ out, long long n, float alpha, float beta,
                 const float* alpha_p, const float* beta_p) {
  if (alpha_p != nullptr) {
    alpha = *alpha_p;
    beta = *beta_p;
  }
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const long long nv = n / V;
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* bv = reinterpret_cast<const uint4*>(b);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      alignas(16) T x[V], y[V];
      *reinterpret_cast<uint4*>(x) = av[i];
      *reinterpret_cast<uint4*>(y) = bv[i];
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = combine(alpha, x[j], beta, y[j]);
      ov[i] = *reinterpret_cast<const uint4*>(x);
    }
    done = nv * V;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = combine(alpha, a[i], beta, b[i]);
}

template <class T>
cudaError_t launch(const void* a, const void* b, void* out, long long n,
                   float alpha, float beta, const float* alpha_p,
                   const float* beta_p, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  // Threads the widest loop needs: the vectors, or the ragged tail if it
  // is longer (n < V), or every element on the scalar path.
  const long long work = vec ? (n / V > n % V ? n / V : n % V) : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* to = static_cast<T*>(out);
  if (vec)
    scale_sum_kernel<T, true><<<(unsigned)blocks, THREADS, 0, st>>>(
        ta, tb, to, n, alpha, beta, alpha_p, beta_p);
  else
    scale_sum_kernel<T, false><<<(unsigned)blocks, THREADS, 0, st>>>(
        ta, tb, to, n, alpha, beta, alpha_p, beta_p);
  return cudaGetLastError();
}

}  // namespace hvdss

// out[i] = alpha * a[i] + beta * b[i] over n elements of one type (dtype 0:
// f32, 1: bf16, 2: f16), out in that type.  alpha_p and beta_p, when not
// null, point to the f32 coefficients on the device and replace alpha and
// beta.
extern "C" int hvd_scale_sum(const void* a, const void* b, void* out,
                             long long n, int dtype, float alpha, float beta,
                             const void* alpha_p, const void* beta_p,
                             void* stream) {
  using namespace hvdss;
  if (n < 1 || (alpha_p == nullptr) != (beta_p == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(alpha_p);
  const float* bp = static_cast<const float*>(beta_p);
  switch (dtype) {
    case 0:
      return (int)launch<float>(a, b, out, n, alpha, beta, ap, bp, st);
    case 1:
      return (int)launch<bf16>(a, b, out, n, alpha, beta, ap, bp, st);
    case 2:
      return (int)launch<__half>(a, b, out, n, alpha, beta, ap, bp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
