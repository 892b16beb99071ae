// Split-TF32 pieces of the f32 flash kernels on Hopper (sm_90a):
// flash_fwd_f32.cu's forward and flash_bwd_f32.cu's dq, dk/dv and one-pass.
//
// An f32 operand x is read as hi + lo: hi its top 19 bits (sign, exponent
// and the top 10 mantissa bits, the part of an f32 word that a TF32
// product reads; the rest it ignores), lo = x - hi, exact in f32, which
// the tensor core truncates to TF32 in turn.  A product a b is then a_lo
// b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, at most 2^-20 of it, dropped):
// three `wgmma` m64nNk8 .tf32 products, within about 2^-19 of the f32
// product.  An f32 tile in shared memory serves as its own hi, so a B
// operand needs one more copy (its lo, written by the producer's warps 1-3
// as the tile lands); an A operand from registers is split there.
#pragma once

#include "sm90.cuh"

namespace hvdf32 {

using namespace sm90;

constexpr int CW = 32;     // columns per operand chunk: a 128-byte row of f32
constexpr int NCONV = 96;  // the producer's warps 1-3, which write lo copies

// The TF32 head of x: its top 19 bits, what the tensor core reads of it.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// d (m64 x N f32, wgmma's accumulator layout) = A B, or d += A B when
// `acc` is not 0: A (m64 x k8 TF32) from registers, four a thread (thread
// t of the warpgroup, r = 16 (t / 32) + (t % 32) / 4, c = t % 4: a[0] row
// r, column c; a[1] row r + 8, column c; a[2], a[3] the same at column
// c + 4), B (k8 x N TF32) from shared memory, K-major.
template <int N>
struct MmaTF32;

#define HVD_TF32_RS_16 \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {" \
      "%0, %1, %2, %3, %4, %5, %6, %7" \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))

#define HVD_TF32_RS_32 \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))

#define HVD_TF32_RS_64 \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))

#define HVD_TF32_RS_128 \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n" \
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))

template <>
struct MmaTF32<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    HVD_TF32_RS_16;
  }
};

template <>
struct MmaTF32<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    HVD_TF32_RS_32;
  }
};

template <>
struct MmaTF32<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    HVD_TF32_RS_64;
  }
};

template <>
struct MmaTF32<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    HVD_TF32_RS_128;
  }
};

#undef HVD_TF32_RS_16
#undef HVD_TF32_RS_32
#undef HVD_TF32_RS_64
#undef HVD_TF32_RS_128

// d (+)= A B in split TF32: A as its hi and lo fragments, B as the
// descriptors of its tile (hi) and of that tile's lo copy; the two small
// terms first, then hi hi.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint64_t bhi,
                                     uint64_t blo, int acc) {
  MmaTF32<N>::run(d, alo, bhi, acc);
  MmaTF32<N>::run(d, ahi, blo, 1);
  MmaTF32<N>::run(d, ahi, bhi, 1);
}

// x as TF32 fragments hi (masked) and lo = x - hi.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_hi(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

// Descriptor of k-step kk (8 keys or columns, 32 bytes) of a K-major f32
// tile stored as 32-column panels of `rows` rows of 128 bytes each.
__device__ __forceinline__ uint64_t desc_tf32(const unsigned char* tile, int rows,
                                              int kk) {
  return desc<128>(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 0, 8 * 128);
}

// lo = x - hi(x) for each of the n4 float4s of a tile (any layout: the
// copy keeps each element's place), shared by the NCONV converter threads
// (ct: this thread's index among them).
__device__ __forceinline__ void write_lo(const unsigned char* raw, unsigned char* lo,
                                         int n4, int ct) {
  const float4* src = reinterpret_cast<const float4*>(raw);
  float4* dst = reinterpret_cast<float4*>(lo);
  for (int i = ct; i < n4; i += NCONV) {
    const float4 x = src[i];
    dst[i] = make_float4(x.x - tf32_hi(x.x), x.y - tf32_hi(x.y), x.z - tf32_hi(x.z),
                         x.w - tf32_hi(x.w));
  }
}

}  // namespace hvdf32
