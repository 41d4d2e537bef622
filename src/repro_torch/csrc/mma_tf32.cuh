// Tensor-core helpers shared by the kernels that compute float32 products
// on Hopper's tensor cores in 3xTF32: fused paged prefill (B2,
// csrc/paged_prefill.cu), dense flash attention (B6,
// csrc/flash_attention.cu), MLA latent-page prefill (B4,
// csrc/mla_paged_prefill.cu) and the chunked SSD scan (B5,
// csrc/ssd_scan.cu).
//
// The products are mma.sync.m16n8k8 TF32 with fp32 accumulators.  TF32
// alone keeps about three digits, so each fp32 operand x is split into
// big = tf32(x) (cvt.rna.tf32.f32) and small = x - big, and a product sums
// small·big + big·small + big·big (3xTF32).  x - big is exact in fp32 and
// handed to the tensor core as it is; the tensor core reads it as TF32 by
// dropping its low 13 bits (truncation, no second cvt).  The error left is
// the dropped small·small term and that truncation, below 2^-20 of each
// product; the fp32 accumulation of the sums costs more, and mma3_acc
// below keeps that to one k-step's.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8, row)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8,
// col) b0 (k t, n g), b1 (k t + 4, n g); C/D (16 x 8) c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "page_types.cuh"

namespace repro_mma {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small: big rounded to TF32, small = x - big exact in fp32, read
// as TF32 (its low 13 bits dropped) by the tensor core
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n] += a·b[n] for N independent n-tiles in 3xTF32 (small·big +
// big·small + big·big), the A fragment given as (big, small) and each B
// fragment as two fp32 values b[n][0..1].  The three passes run over all N
// accumulators in turn, so consecutive mma.sync are independent and their
// latencies overlap.  With kBSmall false the B values are exact in TF32
// (widened from bf16 or fp16: page_types.cuh), their small halves are zero
// and big·small is left out: two products instead of three, same sums.
template <int N, bool kBSmall = true>
__device__ __forceinline__ void mma3(float (&d)[N][4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const float (&b)[N][2]) {
  uint32_t bb[N][2], bs[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b[n][0], bb[n][0], bs[n][0]);
    split(b[n][1], bb[n][1], bs[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], as, bb[n][0], bb[n][1]);
  if constexpr (kBSmall) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n], ab, bs[n][0], bs[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ab, bb[n][0], bb[n][1]);
}

// d[n] += a·b[n] as mma3 computes it, but with this k-step's three products
// (small·big, big·small, big·big) each in its own zeroed accumulator, added
// to d by fp32 adds (round to nearest): d += big·big + (small·big +
// big·small).  mma.sync adds into its accumulator less accurately than
// round to nearest: summed into d, that can cost about an ulp of d in every
// product, which matters where d is large and the sum long (B5's outputs
// reach 100 and more over tens of k-steps, against the card check's
// 1e-4); here it costs an ulp of one k-step's product.  The 3 N products
// are independent, so none waits on another.
template <int N>
__device__ __forceinline__ void mma3_acc(float (&d)[N][4],
                                         const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4],
                                         const float (&b)[N][2]) {
  uint32_t bb[N][2], bs[N][2];
  float z[3][N][4];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b[n][0], bb[n][0], bs[n][0]);
    split(b[n][1], bb[n][1], bs[n][1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) z[0][n][e] = z[1][n][e] = z[2][n][e] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma(z[0][n], as, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(z[1][n], ab, bs[n][0], bs[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(z[2][n], ab, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] += z[2][n][e] + (z[0][n][e] + z[1][n][e]);
}

// o[n] += P·V[n] for the NK output n-tiles of P·V's k-step of 8 keys (B2
// and B6): mma3 over four n-tiles at a time, then over the NK % 4 left
// (head dim 112 has NK = 14: three groups of four and a tail of two), so
// no product reaches past o.  V's B fragment of n-tile n is v0[8 n] and
// v0[st + 8 n] (the k-step's rows 2t and 2t + 1, column g; p_fragment's
// key order), fp32 or 16-bit staged values (a bf16 or fp16 V takes mma3's
// two-product form).
template <int NK, typename T>
__device__ __forceinline__ void pv_mma3(float (&o)[NK][4],
                                        const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4],
                                        const T* v0, int st) {
  using repro_page::to_f32;
  constexpr bool kBSmall = repro_page::kSmallHalf<T>;
#pragma unroll
  for (int n0 = 0; n0 + 4 <= NK; n0 += 4) {
    float vb2[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      vb2[n][0] = to_f32(v0[8 * (n0 + n)]);
      vb2[n][1] = to_f32(v0[st + 8 * (n0 + n)]);
    }
    mma3<4, kBSmall>(*reinterpret_cast<float(*)[4][4]>(&o[n0]), ab, as, vb2);
  }
  constexpr int kTail = NK % 4;
  if constexpr (kTail > 0) {
    constexpr int n0 = NK - kTail;
    float vb2[kTail][2];
#pragma unroll
    for (int n = 0; n < kTail; ++n) {
      vb2[n][0] = to_f32(v0[8 * (n0 + n)]);
      vb2[n][1] = to_f32(v0[st + 8 * (n0 + n)]);
    }
    mma3<kTail, kBSmall>(*reinterpret_cast<float(*)[kTail][4]>(&o[n0]), ab,
                         as, vb2);
  }
}

// The A fragment of rows (g, g + 8), columns (c + t, c + t + 4) of a
// row-major fp32 tile with row stride st, split into (big, small).
__device__ __forceinline__ void load_a(const float* tile, int st, int c, int g,
                                       int t, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  split(tile[g * st + c + t], ab[0], as[0]);
  split(tile[(g + 8) * st + c + t], ab[1], as[1]);
  split(tile[g * st + c + t + 4], ab[2], as[2]);
  split(tile[(g + 8) * st + c + t + 4], ab[3], as[3]);
}

// The A fragment of P·V for one k-step of 8 keys, read from the score
// fragment (C layout) of those keys with no data movement: the k-step's
// keys are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, so the thread that
// holds scores (g, 2t) and (g, 2t + 1) holds exactly A's (g, t) and
// (g, t + 4).  The matching B fragment reads V's rows 2t and 2t + 1.
__device__ __forceinline__ void p_fragment(float p0, float p1, float p2,
                                           float p3, uint32_t (&ab)[4],
                                           uint32_t (&as)[4]) {
  split(p0, ab[0], as[0]);
  split(p2, ab[1], as[1]);
  split(p1, ab[2], as[2]);
  split(p3, ab[3], as[3]);
}

// 16-byte asynchronous copy; pred false fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// max over the four lanes of a quad (the lanes that share a fragment row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace repro_mma
