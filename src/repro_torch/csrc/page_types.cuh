// Page element types of the kernels that read and write KV pages: paged
// decode (B1, csrc/paged_decode.cu), fused paged prefill (B2,
// csrc/paged_prefill.cu), paged verify (B3, csrc/paged_verify.cu) and MLA
// latent-page prefill (B4, csrc/mla_paged_prefill.cu).
//
// Each of them is instantiated over float32 pages and over bfloat16 pages
// (the engine's EngineConfig.dtype).  Queries, the chunk's new rows, the
// outputs and the split scratch are float32 in both.  A bf16 page element
// is widened to fp32 in registers when it is read, and everything after
// that is the float32 kernel's arithmetic.  An fp32 row is rounded to
// nearest even (__float2bfloat16_rn, as torch's .to(torch.bfloat16) and
// JAX's astype) when it is written, and a chunk's own rows are attended
// over as rounded, as the reference reads them back from its pages.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_page {

using bf16 = __nv_bfloat16;

// elements of T in one 16-byte copy: 4 fp32, 8 bf16
template <typename T>
constexpr int kPerChunk = 16 / (int)sizeof(T);

// a bf16 operand is exact in TF32 (8 significant bits against 11), so the
// small half of its 3xTF32 split is zero and its product can be left out
template <typename T>
constexpr bool kSmallHalf = sizeof(T) == 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 widen(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint2 narrow(float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<uint32_t*>(&a),
                    *reinterpret_cast<uint32_t*>(&b));
}

// four consecutive elements (16 bytes in fp32, 8 in bf16, aligned to their
// size) as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  return widen(*reinterpret_cast<const uint2*>(p));
}

// four fp32 values stored as T (rounded to nearest even in bf16)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = narrow(v);
}

// v as a T page holds it: itself in fp32, rounded to nearest even in bf16
template <typename T>
__device__ __forceinline__ float4 round4(float4 v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return widen(narrow(v));
  }
}

// one 16-byte chunk of a T row (kPerChunk<T> elements) from an fp32 row,
// rounded to T, into shared memory: how B2 and B4 stage a chunk's own rows
// (their history rows come from the pages by cp.async)
__device__ __forceinline__ void stage_rounded(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = load4(src);
}
__device__ __forceinline__ void stage_rounded(bf16* dst, const float* src) {
  const uint2 a = narrow(load4(src)), b = narrow(load4(src + 4));
  *reinterpret_cast<uint4*>(dst) = make_uint4(a.x, a.y, b.x, b.y);
}

}  // namespace repro_page
