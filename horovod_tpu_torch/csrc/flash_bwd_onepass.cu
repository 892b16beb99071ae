// Flash-attention one-pass backward for Hopper (sm_90a): dk, dv and the f32
// dq partials in one kernel, in bf16 and in f16.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py _flash_bwd_onepass_kernel,
// launched by _flash_attention_bwd_onepass_flat (HVD_TPU_FLASH_BWD=
// pallas_onepass), at bf16 and f16 inputs.  Same function as flash_bwd.cu's
// two kernels, with q pre-scaled by 1/sqrt(D), products of inputs in T
// (bf16 or f16) with f32 accumulation and every cast to T:
//   p  = exp(q k^T - lse), 0 where masked
//   ds = p * (g v^T - delta)            (delta = rowsum(g * o), from the caller)
//   dv = p^T g     (p cast to g's dtype), summed over the q tiles in f32
//   dk = ds^T q    (ds cast to q's dtype), likewise
//   dqp[bh, t] = ds[:, k tile t] k[k tile t]   (ds cast to k's dtype, f32 out)
// dqp is (BH, nk, S, D) f32, one (S, D) slot per 128-row k tile (the TPU
// plan's k block at S 384); the caller sums the slots (partials.sum(1)) as
// the TPU path sums them in XLA.  q rows wholly above the causal diagonal
// of a k tile are zeros in its slot; rows at or past S are not written.
//
// Bound on the H100 SXM: bytes at D 64.  Five products of 2*D flop per
// live (q, k) pair against the inputs, dk and dv, and nk times dq's size
// in f32 partials.  At BERT-Large's attention (BH 512, S 384, D 64, full,
// nk 3): 48.3 GFLOP (49 us at 989 TFLOP/s, bf16 and f16 alike) against
// 151 MB of partials plus 152 MB of q, k, v, g, lse, delta, dk and dv (91
// us at 3.35 TB/s).  No conversion flushes an f16 subnormal to zero, and
// dS underflows in f16 sooner than in bf16, where the plain version's cast
// sees the same values.
//
// Design (flash_bwd_kv.cuh, whose body the dk/dv kernel of flash_bwd.cu
// shares): one block per (bh, 128-row k tile), a TMA producer warpgroup
// and two wgmma consumers of 64 k rows each, dk and dv in registers, P^T
// and dS^T built in registers.  Here the body also writes dS^T to shared
// memory as T and adds the dq partial dS K, one more wgmma, each
// consumer's f32 half stored into the tile's slot by TMA from a
// double-buffered swizzled tile while the next q tile computes.  Every
// block writes only its own slot: no atomics, and the partials repeat bit
// for bit.
//
// Left on the table: the atomic-add dq variant (nk-fold partial traffic
// traded for f32 atomics, or TMA reduce-add), overlap of one q tile's
// softmax with the next tile's products, and a persistent grid.
#include "flash_bwd_kv.cuh"

namespace hvdflash {

using namespace sm90;

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_bwd_onepass_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mg,
                         const __grid_constant__ CUtensorMap mlse,
                         const __grid_constant__ CUtensorMap mdelta,
                         const __grid_constant__ CUtensorMap mdqp,
                         const __grid_constant__ CUtensorMap mdk,
                         const __grid_constant__ CUtensorMap mdv,
                         float* __restrict__ dqp, int S) {
  kv::ktile_body<T, D, CAUSAL, true>(mq, mk, mv, mg, mlse, mdelta, mdqp, mdk,
                                     mdv, dqp, S);
}

template <typename T, int D, bool CAUSAL>
static cudaError_t launch_onepass(const void* q, const void* k, const void* v,
                                  const void* g, const void* lse,
                                  const void* delta, void* dqp, void* dk,
                                  void* dv, int bh, int s, cudaStream_t stream) {
  const int nk = (s + kv::BK - 1) / kv::BK;
  CUtensorMap mq, mk, mv, mg, mlse, mdelta, mdqp, mdk, mdv;
  cudaError_t err;
  if ((err = kv::ktile_maps<T, D>(
           &mq, &mk, &mv, &mg, &mlse, &mdelta, &mdk, &mdv,
           static_cast<const T*>(q), static_cast<const T*>(k),
           static_cast<const T*>(v), static_cast<const T*>(g),
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           static_cast<T*>(dk), static_cast<T*>(dv), bh, s)) != cudaSuccess ||
      (err = panel_map<D / 2>(&mdqp, static_cast<const float*>(dqp), s,
                              (uint64_t)bh * nk, kv::BQ, D)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_onepass_kernel<T, D, CAUSAL>;
  const size_t bytes = kv::Smem<T, D, true>::bytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, nk);
  kernel<<<grid, 384, bytes, stream>>>(mq, mk, mv, mg, mlse, mdelta, mdqp, mdk, mdv,
                                       static_cast<float*>(dqp), s);
  return cudaGetLastError();
}

}  // namespace hvdflash

// dtype: 1 float16, 2 bfloat16 (the codes of flash_simt.cu).  d: 32, 64 or
// 128.  Returns a cudaError_t (cudaErrorInvalidValue for a dtype, d or
// block_k it does not take).
extern "C" int hvd_flash_bwd_onepass(const void* q, const void* k, const void* v,
                                     const void* g, const void* lse,
                                     const void* delta, void* dqp, void* dk,
                                     void* dv, int bh, int s, int d, int causal,
                                     int block_k, int dtype, void* stream) {
  using namespace hvdflash;
  // the caller allocates one partial slot per block_k rows of k; the
  // kernel writes one per BK
  if (block_k != kv::BK) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define HVD_ONEPASS(T, DD)                                                    \
  case DD:                                                                    \
    return causal                                                             \
        ? launch_onepass<T, DD, true>(q, k, v, g, lse, delta, dqp, dk, dv,    \
                                      bh, s, st)                              \
        : launch_onepass<T, DD, false>(q, k, v, g, lse, delta, dqp, dk, dv,   \
                                       bh, s, st);
#define HVD_ONEPASS_WIDTHS(T)                                                 \
  switch (d) {                                                                \
    HVD_ONEPASS(T, 32)                                                        \
    HVD_ONEPASS(T, 64)                                                        \
    HVD_ONEPASS(T, 128)                                                       \
    default:                                                                  \
      return (int)cudaErrorInvalidValue;                                      \
  }
  if (dtype == 1) HVD_ONEPASS_WIDTHS(__half)
  if (dtype == 2) HVD_ONEPASS_WIDTHS(__nv_bfloat16)
  return (int)cudaErrorInvalidValue;
#undef HVD_ONEPASS_WIDTHS
#undef HVD_ONEPASS
}
