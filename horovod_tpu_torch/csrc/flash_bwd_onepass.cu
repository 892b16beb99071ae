// Flash-attention one-pass backward for Hopper (sm_90a): dk, dv and the f32
// dq partials in one kernel, in bf16 and in f16, at head dims 32, 64, 128,
// 256 and every multiple of 128 past 256.
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
// dqp is (BH, nk, S, D) f32, one (S, D) slot per onepass_block_k rows of
// k: 128 up to D 128 (the TPU plan's k block at S 384) and past 256, 64
// at D 256 (the TPU plan's smallest, and the only k block a D-256 block
// holds: below); the caller sums the slots (partials.sum(1)) as the TPU
// path sums them in XLA.  q rows wholly above the causal diagonal of a
// slot are zeros in it; rows at or past S are not written.
//
// Bound on the H100 SXM: bytes.  Five products of 2*D flop per live (q,
// k) pair against the inputs, dk and dv, and nk times dq's size in f32
// partials.  At BERT-Large's attention (BH 512, S 384, D 64, full, nk 3):
// 48.3 GFLOP (49 us at 989 TFLOP/s, bf16 and f16 alike) against 151 MB
// of partials plus 152 MB of q, k, v, g, lse, delta, dk and dv (91 us at
// 3.35 TB/s).  At the hd256 decoder's (BH 32, S 2048, D 256, causal, nk
// 32 of 64 rows): 172 GFLOP (0.174 ms) against 2.15 GB of partials plus
// 0.2 GB (0.70 ms); 64-row slots double the partials' bytes that 128-row
// ones would take, and the caller's sum reads them once more (0.66 ms), so
// this plan cannot beat a backward that forms dq without partials.  At
// BH 32, S 2048, D 384, causal (nk 16 of 128 rows): 258 GFLOP (0.261 ms)
// against 1.61 GB of partials plus 0.30 GB (0.571 ms).  No conversion
// flushes an f16 subnormal to zero, and dS underflows in f16
// sooner than in bf16, where the plain version's cast sees the same
// values.
//
// Design up to D 128 (flash_bwd_kv.cuh's kv::ktile_body, which the dk/dv
// kernel of flash_bwd.cu shares): one block per (bh, 128-row k tile), a
// TMA producer warpgroup and two wgmma consumers of 64 k rows each, dk
// and dv in registers, P^T and dS^T built in registers.  Here the body
// also writes dS^T to shared memory as T and adds the dq partial dS K,
// one more wgmma, each consumer's f32 half stored into the tile's slot by
// TMA from a double-buffered swizzled tile while the next q tile
// computes.  Every block writes only its own slot: no atomics, and the
// partials repeat bit for bit.
//
// At D 256 (flash_bwd_onepass_d256_kernel, body kv256::kblock_body, which
// flash_bwd.cu's dk/dv kernel at 256 shares): one block per (bh, 64-row k
// block) whose two consumers split the products (P^T and dV; dP^T, dS^T
// and dK); consumer 1 also writes dS^T to shared memory, and each consumer
// forms the partial's 128 columns of its half by one more wgmma, stored
// from registers.
//
// Past 256 (flash_bwd_onepass_wide_kernel<T, W, CAUSAL>, body
// flash_bwd_kv.cuh's wide::kv_body, which flash_bwd.cu's dk/dv kernel past
// 256 shares): dk/dv's panel plan, one block per (bh, 128-row dq slot,
// panel of 256 columns or a last 128), two launches by width
// (wide::by_panels).  The block walks the slot's two 64-row k blocks in
// turn (kv256's split of the products each, the scores streamed in
// 64-column chunks in one order in every panel block), stores dk and dv
// after each walk, and adds dS K[:, panel] into the slot's q rows: consumer
// 1 writes dS^T to shared memory, and each consumer forms W / 2 of the
// panel's partial columns by wgmma against K's panel of the k block, in
// 64-column pieces stored from registers, the second k block adding to
// what the first stored (the same thread, the same elements: no fence, no
// atomics, the bits repeat).  Shared memory 216 KB at W 256 (three ring
// stages where dk/dv takes four; budget in flash_bwd_kv.cuh).  Its bytes
// at D 384 (the sizes above): the second walk reads back and rewrites its
// live rows of the slot, about 1.61 GB more, so 3.52 GB in all (1.05 ms
// at 3.35 TB/s); its FLOP, S and dP formed again in each panel block, 14
// D a live pair (0.365 ms).
//
// Left on the table: the atomic-add dq variant (nk-fold partial traffic
// traded for f32 atomics, or TMA reduce-add), overlap of one q tile's
// softmax with the next tile's products, and a persistent grid; at D 256
// also storing a tile's partial while the next tile's products run (the
// stores now wait on the partial's wgmma), and 128-row slots (two 64-row
// blocks adding into one, or one block walking both halves); past 256 the
// second walk's read-back (a TMA reduce-add of the partial, or whole-slot
// k blocks at W 128), S and dP formed once per tile for every panel, and
// four ring stages.
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

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_bwd_onepass_d256_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const __grid_constant__ CUtensorMap mg,
                              const __grid_constant__ CUtensorMap mlse,
                              const __grid_constant__ CUtensorMap mdelta,
                              const __grid_constant__ CUtensorMap mdk,
                              const __grid_constant__ CUtensorMap mdv,
                              float* __restrict__ dqp, int S) {
  static_assert(D == 256, "the D 256 plan");
  kv256::kblock_body<T, CAUSAL, true>(mq, mk, mv, mg, mlse, mdelta, mdk, mdv, dqp,
                                      S);
}

template <typename T, bool CAUSAL>
static cudaError_t launch_onepass_d256(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const void* lse, const void* delta,
                                       void* dqp, void* dk, void* dv, int bh,
                                       int s, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg, mlse, mdelta, mdk, mdv;
  cudaError_t err = kv::ktile_maps<T, 256>(
      &mq, &mk, &mv, &mg, &mlse, &mdelta, &mdk, &mdv, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), bh, s, kv256::BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_onepass_d256_kernel<T, 256, CAUSAL>;
  const size_t bytes = kv256::Smem<T, true>::bytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (s + kv256::BK - 1) / kv256::BK);
  kernel<<<grid, 384, bytes, stream>>>(mq, mk, mv, mg, mlse, mdelta, mdk, mdv,
                                       static_cast<float*>(dqp), s);
  return cudaGetLastError();
}

template <typename T, int W, bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_bwd_onepass_wide_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const __grid_constant__ CUtensorMap mg,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dk,
                              T* __restrict__ dv, float* __restrict__ dqp, int S, int DW,
                              int z0) {
  wide::kv_body<T, W, CAUSAL, true>(mq, mk, mv, mg, lse, delta, dk, dv, dqp, S, DW, z0);
}

// One launch of panels [z0, z0 + nz) of W columns each, a block per (bh,
// 128-row dq slot, panel).
template <typename T, int W, bool CAUSAL>
static cudaError_t launch_onepass_panels(const CUtensorMap (&m)[4], const float* lse,
                                         const float* delta, T* dk, T* dv, float* dqp,
                                         int bh, int s, int d, int z0, int nz,
                                         cudaStream_t stream) {
  using L = wide::dkv::Smem<T, W, true>;
  auto kernel = flash_bwd_onepass_wide_kernel<T, W, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  constexpr int slot = L::NKB * wide::BK;
  dim3 grid(bh, (s + slot - 1) / slot, nz);
  kernel<<<grid, 384, L::bytes, stream>>>(m[0], m[1], m[2], m[3], lse, delta, dk, dv, dqp,
                                          s, d, z0);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
static cudaError_t launch_onepass_wide(const void* q, const void* k, const void* v,
                                       const void* g, const void* lse,
                                       const void* delta, void* dqp, void* dk,
                                       void* dv, int bh, int s, int d,
                                       cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err = wide::chunk_maps<T>(
      &m[0], &m[1], &m[2], &m[3], static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), bh, s, d, wide::dkv::BQ);
  if (err != cudaSuccess) return err;
  auto LSE = static_cast<const float*>(lse);
  auto DEL = static_cast<const float*>(delta);
  auto DK = static_cast<T*>(dk);
  auto DV = static_cast<T*>(dv);
  auto DQP = static_cast<float*>(dqp);
  return wide::by_panels(
      d,
      [&](int z0, int nz) {
        return launch_onepass_panels<T, 256, CAUSAL>(m, LSE, DEL, DK, DV, DQP, bh, s, d,
                                                     z0, nz, stream);
      },
      [&](int z0, int nz) {
        return launch_onepass_panels<T, 128, CAUSAL>(m, LSE, DEL, DK, DV, DQP, bh, s, d,
                                                     z0, nz, stream);
      });
}

// The one-pass by width: at 256 the 64-row k-block plan, up to 128 the
// k-tile body.
template <typename T, int D, bool CAUSAL>
static cudaError_t run_onepass(const void* q, const void* k, const void* v,
                               const void* g, const void* lse, const void* delta,
                               void* dqp, void* dk, void* dv, int bh, int s,
                               cudaStream_t stream) {
  if constexpr (D == 256)
    return launch_onepass_d256<T, CAUSAL>(q, k, v, g, lse, delta, dqp, dk, dv, bh,
                                          s, stream);
  else
    return launch_onepass<T, D, CAUSAL>(q, k, v, g, lse, delta, dqp, dk, dv, bh,
                                        s, stream);
}

}  // namespace hvdflash

// dtype: 1 float16, 2 bfloat16 (the codes of flash_simt.cu).  d: 32, 64,
// 128, 256, or a multiple of 128 past 256.  block_k: the rows of k per
// partial slot the caller allocated, 64 at 256 and 128 at every other d
// (ops/flash_attention.py onepass_block_k).  Returns a cudaError_t
// (cudaErrorInvalidValue for a dtype, d or block_k it does not take).
extern "C" int hvd_flash_bwd_onepass(const void* q, const void* k, const void* v,
                                     const void* g, const void* lse,
                                     const void* delta, void* dqp, void* dk,
                                     void* dv, int bh, int s, int d, int causal,
                                     int block_k, int dtype, void* stream) {
  using namespace hvdflash;
  // the caller allocates one partial slot per block_k rows of k; the
  // kernel writes one per k block of its plan (past 256 one per two of
  // its 64-row k blocks: kv::BK rows)
  if (block_k != (d == 256 ? kv256::BK : kv::BK))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define HVD_ONEPASS(T, DD)                                                    \
  case DD:                                                                    \
    return causal                                                             \
        ? run_onepass<T, DD, true>(q, k, v, g, lse, delta, dqp, dk, dv, bh,   \
                                   s, st)                                     \
        : run_onepass<T, DD, false>(q, k, v, g, lse, delta, dqp, dk, dv, bh,  \
                                    s, st);
#define HVD_ONEPASS_WIDTHS(T)                                                 \
  switch (d) {                                                                \
    HVD_ONEPASS(T, 32)                                                        \
    HVD_ONEPASS(T, 64)                                                        \
    HVD_ONEPASS(T, 128)                                                       \
    HVD_ONEPASS(T, 256)                                                       \
    default:                                                                  \
      if (d > 256 && d % 128 == 0)                                            \
        return causal ? launch_onepass_wide<T, true>(q, k, v, g, lse, delta,  \
                                                     dqp, dk, dv, bh, s, d,   \
                                                     st)                      \
                      : launch_onepass_wide<T, false>(q, k, v, g, lse, delta, \
                                                      dqp, dk, dv, bh, s, d,  \
                                                      st);                    \
      return (int)cudaErrorInvalidValue;                                      \
  }
  if (dtype == 1) HVD_ONEPASS_WIDTHS(__half)
  if (dtype == 2) HVD_ONEPASS_WIDTHS(__nv_bfloat16)
  return (int)cudaErrorInvalidValue;
#undef HVD_ONEPASS_WIDTHS
#undef HVD_ONEPASS
}
