// Hopper (sm_90a) primitives in PTX for the flash kernels: tensor maps,
// mbarriers, TMA loads and stores, wgmma descriptors and products, and
// register reallocation.
//
// cuTensorMapEncodeTiled is called through the entry point that the CUDA
// runtime hands out for it (cudaGetDriverEntryPoint), so no library
// links libcuda and the build stays one plain nvcc call per source.
//
// Shared-memory tiles are the TMA's swizzled layouts: rows of SWZ bytes
// (128 or 64), 16-byte chunks XOR-ed with bits 7.. of the offset, bases
// aligned to 1024 bytes.  A wider matrix is split into panels of SWZ
// bytes, one TMA box each.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tiled map of a row-major tensor: dims[0] is the contiguous one,
// strides[i] the byte stride of dims[i + 1]; out-of-range elements load
// as zeros and are not stored.
inline cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type,
                              int rank, const void* base, const uint64_t* dims,
                              const uint64_t* strides, const uint32_t* box,
                              CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), d, s, b,
                  e, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline CUtensorMapSwizzle swizzle_mode(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset `off` from a 1024-aligned tile base, in the layout that
// a TMA box with a SWZ-byte swizzle gives.
template <int SWZ>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  static_assert(SWZ == 128 || SWZ == 64, "128- or 64-byte swizzle");
  constexpr uint32_t mask = SWZ == 128 ? 7 : 3;
  return off ^ ((off >> 3) & (mask << 4));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the barrier's phase with parity `parity` has completed.  A
// build with HVD_SM90_WATCHDOG defined (tools/chip_fault_check.py's
// copies) traps on a wait that has not ended after about 2^33 cycles
// (seconds), so that a planted lost arrival ends the launch with an error
// instead of hanging the card; the shipped wait only spins.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
#ifdef HVD_SM90_WATCHDOG
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
#else
  while (!mbar_try_wait(addr, parity)) {
  }
#endif
}

__device__ __forceinline__ uint64_t map_addr(const CUtensorMap& map) {
  return reinterpret_cast<uint64_t>(&map);
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap& map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map_addr(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap& map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map_addr(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap& map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(map_addr(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N committed store groups still read shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory become visible to the async
// proxy (TMA stores, wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `threads` threads (a multiple of 32) on hardware barrier `id`.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a SWZ-byte swizzled tile.  K-major
// (the reduction axis contiguous): `sbo` is the byte stride of 8-row
// groups, `lbo` unused.  MN-major (the output axis contiguous): `lbo` is
// the byte stride of SWZ-byte panels along M or N, `sbo` that of 8-row
// groups along K.
template <int SWZ>
__device__ __forceinline__ uint64_t desc(const void* tile, uint32_t lbo,
                                         uint32_t sbo) {
  constexpr uint64_t layout = SWZ == 128 ? 1 : 2;  // the 128- or 64-byte swizzle
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers in place around the asynchronous products,
// so that the compiler moves no read or write of them across a fence or
// a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The operand types of the tensor-core products: bf16 and f16, each with
// f32 accumulation.  Each names its tensor map's element type and whether
// its products are wgmma's .f16 or .bf16 kind; f32 tiles (the dq outputs
// and partials) are stored by TMA only.
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType map = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr bool f16 = false;
};
template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType map = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static constexpr bool f16 = true;
};
template <>
struct Elem<float> {
  static constexpr CUtensorMapDataType map = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr bool f16 = false;
};

// Two f32 values as one register of bf16, or of f16 (lo in the low
// half), rounded to nearest even: what .to(dtype) does.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (Elem<T>::f16)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}


// ---------------------------------------------------------------------------
// device: swizzled panel tiles and their descriptors
// ---------------------------------------------------------------------------

// A tile of R rows of C elements of E bytes, stored as NP panels of PC
// columns (one TMA box each, SWZ bytes a row): panel p holds columns
// [p PC, p PC + PC) of every row, at p R SWZ bytes from the tile base.
template <int C, int E = 2>
struct Panels {
  static constexpr int SWZ = C * E >= 128 ? 128 : C * E;
  static constexpr int PC = SWZ / E;
  static constexpr int NP = C / PC;
  static_assert(SWZ == 128 || SWZ == 64, "panels of 64 or 128 bytes");
};

// A row-major (depth, rows, width) tensor of T (bf16, f16 or f32) as a
// 3-D map of T's element type whose boxes are one panel of a C-column
// tile (Panels<C, sizeof(T)>) by `box_rows` rows.
template <int C, typename T>
inline cudaError_t panel_map(CUtensorMap* map, const T* base, uint64_t rows,
                             uint64_t depth, uint32_t box_rows,
                             uint64_t width = C) {
  constexpr int E = sizeof(T);
  using P = Panels<C, E>;
  const uint64_t dims[3] = {width, rows, depth};
  const uint64_t strides[2] = {width * E, rows * width * E};
  const uint32_t box[3] = {(uint32_t)P::PC, box_rows, 1};
  return encode_map(map, Elem<T>::map, 3, base, dims, strides, box,
                    swizzle_mode(P::SWZ));
}

// Byte offset of element (r, c) in such a tile.
template <int C, int R, int E = 2>
__device__ __forceinline__ uint32_t panel_offset(int r, int c) {
  using P = Panels<C, E>;
  return (c / P::PC) * (R * P::SWZ) + swz<P::SWZ>(r * P::SWZ + (c % P::PC) * E);
}

// Descriptor of a bf16 or f16 tile of R rows and C columns read K-major: the
// product's reduction runs along C, this is its k-step kk (columns
// [16 kk, 16 kk + 16)), and the rows are the product's M or N.
template <int C, int R>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk) {
  using P = Panels<C>;
  const int col = 16 * kk;
  const char* p = static_cast<const char*>(tile) + (col / P::PC) * (R * P::SWZ) +
                  (col % P::PC) * 2;
  return desc<P::SWZ>(p, 0, 8 * P::SWZ);
}

// Descriptor of the same tile read MN-major: the reduction runs along
// the rows (k-step kk: rows [16 kk, 16 kk + 16)), and the product's M or
// N along the columns, from column n0.
template <int C, int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk,
                                                 int n0 = 0) {
  using P = Panels<C>;
  const char* p = static_cast<const char*>(tile) + (n0 / P::PC) * (R * P::SWZ) +
                  (n0 % P::PC) * 2 + 16 * kk * P::SWZ;
  return desc<P::SWZ>(p, R * P::SWZ, 8 * P::SWZ);
}

// d (m64 x N f32, the accumulator layout) = A (m64 x k16) B (k16 x N), or
// d += A B when `acc` is not 0, with A and B in shared memory (descriptors;
// TA/TB 1 = MN-major), both of T (bf16 or f16: wgmma's .bf16 or .f16 kind,
// the same shapes and transpose bits).
// Accumulator layout, thread t of the warpgroup: rows 16 (t / 32) + (t % 32) / 4
// and 8 more; d[4 j + {0, 1}] are columns 8 j + 2 (t % 4) + {0, 1} of the
// first row, d[4 j + {2, 3}] the same columns of the second.
template <int N, int TA, int TB, typename T = __nv_bfloat16>
struct MmaSS;

// The same with A from registers: four pairs of T in the accumulator's
// layout for 16 columns (a[0]: first row, columns 2 (t % 4) + {0, 1};
// a[1]: second row; a[2], a[3]: 8 columns on).  So an m64 x N f32
// accumulator d whose columns are the next product's reduction axis packs
// into that product's A registers as pack<T>(d[2 x], d[2 x + 1]) for
// x = 0 .. N/2 - 1, k-step kk taking x = 4 kk .. 4 kk + 3.
template <int N, int TB, typename T = __nv_bfloat16>
struct MmaRS;

// One asm statement per shape, its operand types TY ("bf16" or "f16").
#define HVD_WGMMA_SS_16(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB))

#define HVD_WGMMA_SS_32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB))

#define HVD_WGMMA_SS_64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB))

#define HVD_WGMMA_SS_128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB))

#define HVD_WGMMA_RS_32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), \
        "n"(TB))

#define HVD_WGMMA_RS_64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), \
        "n"(TB))

#define HVD_WGMMA_RS_128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), \
        "n"(TB))

#define HVD_WGMMA_RS_256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, " \
      "%104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), \
        "n"(TB))

template <int TA, int TB, typename T>
struct MmaSS<16, TA, TB, T> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t da,
                                             uint64_t db, int acc) {
    if constexpr (Elem<T>::f16)
      HVD_WGMMA_SS_16("f16");
    else
      HVD_WGMMA_SS_16("bf16");
  }
};

template <int TA, int TB, typename T>
struct MmaSS<32, TA, TB, T> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
    if constexpr (Elem<T>::f16)
      HVD_WGMMA_SS_32("f16");
    else
      HVD_WGMMA_SS_32("bf16");
  }
};

template <int TA, int TB, typename T>
struct MmaSS<64, TA, TB, T> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    if constexpr (Elem<T>::f16)
      HVD_WGMMA_SS_64("f16");
    else
      HVD_WGMMA_SS_64("bf16");
  }
};

template <int TA, int TB, typename T>
struct MmaSS<128, TA, TB, T> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
    if constexpr (Elem<T>::f16)
      HVD_WGMMA_SS_128("f16");
    else
      HVD_WGMMA_SS_128("bf16");
  }
};

template <int TB, typename T>
struct MmaRS<32, TB, T> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    if constexpr (Elem<T>::f16)
      HVD_WGMMA_RS_32("f16");
    else
      HVD_WGMMA_RS_32("bf16");
  }
};

template <int TB, typename T>
struct MmaRS<64, TB, T> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    if constexpr (Elem<T>::f16)
      HVD_WGMMA_RS_64("f16");
    else
      HVD_WGMMA_RS_64("bf16");
  }
};

template <int TB, typename T>
struct MmaRS<128, TB, T> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    if constexpr (Elem<T>::f16)
      HVD_WGMMA_RS_128("f16");
    else
      HVD_WGMMA_RS_128("bf16");
  }
};

template <int TB, typename T>
struct MmaRS<256, TB, T> {
  static __device__ __forceinline__ void run(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    if constexpr (Elem<T>::f16)
      HVD_WGMMA_RS_256("f16");
    else
      HVD_WGMMA_RS_256("bf16");
  }
};

#undef HVD_WGMMA_SS_16
#undef HVD_WGMMA_SS_32
#undef HVD_WGMMA_SS_64
#undef HVD_WGMMA_SS_128
#undef HVD_WGMMA_RS_32
#undef HVD_WGMMA_RS_64
#undef HVD_WGMMA_RS_128
#undef HVD_WGMMA_RS_256

}  // namespace sm90
