// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (Pallas body _paged_kernel).  One query token per lane attends over its
// KV history scattered across pages addressed by a block table, with a
// flash-style online softmax page by page and an optional sliding window.
//
// What bounds it on an H100: bytes.  Each (lane, KV head) reads its whole
// K/V history once and does 2*G*hd flops per key (G = query heads per KV
// head, 2 or 3 here), far below the ~20 flop/byte float32 ridge, so the
// floor is K/V bytes over 3.35 TB/s.
//
// What the design does about it: one block per (lane, KV head) holds the
// whole GQA group of queries, so every K/V page is read from device
// memory once for all G heads that share it (the TPU kernel's grouping).
// Pages are staged through shared memory with coalesced loads along hd.
// The loop runs only over pages [lo, ceil(seq_len/page)): a window skips
// pages wholly below seq_len - window, and pages past the end are never
// read (the TPU kernel walks max_pages and masks them; every decode lane
// has seq_len >= 1, so the result is the same).  With B*KVH blocks the
// card is far from full at small batch: a split over pages with a reduce
// pass is the next step, not part of this simple version.
//
// Semantics kept from the TPU kernel: masked scores are NEG_INF = -1e30,
// the softmax denominator is floored at 1e-30, accumulation is float32.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__global__ void paged_decode_kernel(
    const float* __restrict__ q,          // (B, H, hd)
    const float* __restrict__ k_pages,    // (n_pages, page, KVH, hd)
    const float* __restrict__ v_pages,
    const int* __restrict__ block_table,  // (B, max_pages)
    const int* __restrict__ seq_lens,     // (B,)
    float* __restrict__ out,              // (B, H, hd)
    int H, int KVH, int hd, int page, int max_pages, float scale,
    int window) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int ks = hd + 1;  // padded K row stride: no bank conflicts in dots

  extern __shared__ float smem[];
  float* q_s = smem;                  // G * hd
  float* k_s = q_s + G * hd;          // page * (hd + 1)
  float* v_s = k_s + page * ks;       // page * hd
  float* s_s = v_s + page * hd;       // G * page
  float* acc = s_s + G * page;        // G * hd
  float* m_s = acc + G * hd;          // G
  float* l_s = m_s + G;               // G
  float* a_s = l_s + G;               // G (per-row rescale of this page)

  const float* qb = q + ((long long)b * H + (long long)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = qb[i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int seq_len = seq_lens[b];
  int lo = 0;
  if (window > 0) {
    lo = (seq_len - window) / page;
    if (seq_len - window < 0) lo = 0;  // floor division of a negative
  }
  int hi = (seq_len + page - 1) / page;
  if (hi > max_pages) hi = max_pages;
  const long long row = (long long)KVH * hd;  // floats per token slot

  for (int i = lo; i < hi; ++i) {
    const long long pid = block_table[(long long)b * max_pages + i];
    const float* kp = k_pages + pid * page * row + (long long)kvh * hd;
    const float* vp = v_pages + pid * page * row + (long long)kvh * hd;
    __syncthreads();  // previous page's v_s / s_s fully consumed
    for (int e = tid; e < page * hd; e += kThreads) {
      const int p = e / hd, d = e - p * hd;
      k_s[p * ks + d] = kp[p * row + d];
      v_s[e] = vp[p * row + d];
    }
    __syncthreads();
    for (int e = tid; e < G * page; e += kThreads) {
      const int g = e / page, p = e - g * page;
      const float* qr = q_s + g * hd;
      const float* kr = k_s + p * ks;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
      const int pos = i * page + p;
      bool valid = pos < seq_len;
      if (window > 0) valid = valid && (pos >= seq_len - window);
      s_s[e] = valid ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float* sr = s_s + g * page;
      const float m_old = m_s[g];
      float m_new = m_old;
      for (int p = 0; p < page; ++p) m_new = fmaxf(m_new, sr[p]);
      float sum = 0.f;
      for (int p = 0; p < page; ++p) {
        const float e = expf(sr[p] - m_new);
        sr[p] = e;
        sum += e;
      }
      const float alpha = expf(m_old - m_new);
      a_s[g] = alpha;
      m_s[g] = m_new;
      l_s[g] = l_s[g] * alpha + sum;
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += kThreads) {
      const int g = e / hd, d = e - g * hd;
      const float* pr = s_s + g * page;
      float pv = 0.f;
      for (int p = 0; p < page; ++p) pv += pr[p] * v_s[p * hd + d];
      acc[e] = acc[e] * a_s[g] + pv;
    }
  }
  __syncthreads();
  float* ob = out + ((long long)b * H + (long long)kvh * G) * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    ob[e] = acc[e] / fmaxf(l_s[e / hd], 1e-30f);
  }
}

}  // namespace

extern "C" int repro_paged_decode_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* block_table, const int* seq_lens, float* out, int B, int H,
    int KVH, int hd, int page, int max_pages, float scale, int window,
    void* stream) {
  const int G = H / KVH;
  const size_t smem = sizeof(float) *
      (size_t)(G * hd + page * (hd + 1) + page * hd + G * page + G * hd +
               3 * G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, KVH);
  paged_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, k_pages, v_pages, block_table, seq_lens, out, H, KVH, hd, page,
      max_pages, scale, window);
  return (int)cudaGetLastError();
}
