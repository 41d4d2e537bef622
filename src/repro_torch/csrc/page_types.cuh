// Page element types of the kernels that read and write KV pages: paged
// decode (B1, csrc/paged_decode.cu), fused paged prefill (B2,
// csrc/paged_prefill.cu), paged verify (B3, csrc/paged_verify.cu) and MLA
// latent-page prefill (B4, csrc/mla_paged_prefill.cu); B1's bf16 queries,
// B5 (csrc/ssd_scan.cu) and B6 (csrc/flash_attention.cu) read and write
// bf16 tensors through the same helpers.
//
// Each of B1-B4 is instantiated over float32, bfloat16 and float16 pages
// (the engine's EngineConfig.dtype).  Queries, the chunk's new rows, the
// outputs and the split scratch are float32 in all three.  A 16-bit page
// element is widened to fp32 in registers when it is read (exact), and
// everything after that is the float32 kernel's arithmetic.  An fp32 row
// is rounded to nearest even when it is written (__floats2bfloat162_rn /
// __floats2half2_rn, as torch's .to(dtype) and JAX's astype; a value past
// float16's largest finite 65504 becomes inf in all three, and is not
// clamped), and a chunk's own rows are attended over as rounded, as the
// reference reads them back from its pages.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_page {

using bf16 = __nv_bfloat16;
using f16 = __half;

// elements of T in one 16-byte copy: 4 fp32, 8 bf16 or f16
template <typename T>
constexpr int kPerChunk = 16 / (int)sizeof(T);

// a 16-bit operand is exact in TF32, so the small half of its 3xTF32
// split is zero and its product can be left out: bf16 has 8 significant
// bits and fp16 11 against TF32's 11, and both exponent ranges (fp16's
// subnormals included, down to 2^-24) lie inside TF32's 8-bit exponent
template <typename T>
constexpr bool kSmallHalf = sizeof(T) == 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

// two 16-bit elements packed in a 32-bit word, as fp32 (exact)
template <typename T>
__device__ __forceinline__ float2 widen2(uint32_t w) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  } else {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
}

// two fp32 values rounded to nearest even as T and packed in a word
template <typename T>
__device__ __forceinline__ uint32_t narrow2(float a, float b) {
  if constexpr (std::is_same_v<T, bf16>) {
    __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&r);
  } else {
    __half2 r = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&r);
  }
}

template <typename T>
__device__ __forceinline__ float4 widen(uint2 u) {
  const float2 a = widen2<T>(u.x), b = widen2<T>(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ uint2 narrow(float4 v) {
  return make_uint2(narrow2<T>(v.x, v.y), narrow2<T>(v.z, v.w));
}

// four consecutive elements (16 bytes in fp32, 8 in bf16 / f16, aligned to
// their size) as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  return widen<bf16>(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 load4(const f16* p) {
  return widen<f16>(*reinterpret_cast<const uint2*>(p));
}

// four fp32 values stored as T (rounded to nearest even in bf16 / f16)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = narrow<bf16>(v);
}
__device__ __forceinline__ void store4(f16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = narrow<f16>(v);
}

// two fp32 values stored as T at p (8 bytes in fp32, 4 in bf16 / f16,
// aligned to their size): how the tensor-core kernels write an output
// fragment's pair of columns
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = narrow2<bf16>(a, b);
}

// one fp32 value stored as T
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(bf16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

// v as a T page holds it: itself in fp32, rounded to nearest even in a
// 16-bit type
template <typename T>
__device__ __forceinline__ float4 round4(float4 v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return widen<T>(narrow<T>(v));
  }
}

// one 16-byte chunk of a T row (kPerChunk<T> elements) from an fp32 row,
// rounded to T, into shared memory: how B2 and B4 stage a chunk's own rows
// (their history rows come from the pages by cp.async)
template <typename T>
__device__ __forceinline__ void stage_rounded(T* dst, const float* src) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = load4(src);
  } else {
    const uint2 a = narrow<T>(load4(src)), b = narrow<T>(load4(src + 4));
    *reinterpret_cast<uint4*>(dst) = make_uint4(a.x, a.y, b.x, b.y);
  }
}

}  // namespace repro_page
