// Fused speculative-verify paged attention for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/paged_prefill.py, paged_verify_attention
// (which runs the Pallas body _prefill_kernel on the verify window).  The
// target model scores its verify window of sl + 1 tokens (the last emitted
// token and the draft's sl proposals, bucketed to S = 8 or 16 rows) against
// the lane's paged history.  The function is the fused chunked prefill's:
// the window's K/V rows are written into the lane's pages (row i lands at
// position pos0[b] + i, only for i < chunk_len[b]), and every live row
// attends causally (with an optional sliding window) over the history and
// the window itself.  Output rows at i >= chunk_len[b] are zeros.
//
// What bounds it on an H100: bytes.  A verify reads the history's K/V rows
// once (2 * n_hist * KVH * hd floats) and does 4 * hd flops per (query
// head, key), which for G * S <= 48 query rows per KV head stays below the
// float32 ridge of ~20 flop/byte.  The floor is the history bytes over
// 3.35 TB/s: about 1.4 us for qwen3-1.7b (8 KV heads, hd 128) at 560 keys.
//
// What the design does about it: the shape is a few rows over a long
// history, so the work is split over keys.  Grid (lane, KV head, split):
// each block stages all G * chunk_len live query rows of its KV-head group
// once (every staged K/V row serves all of them), walks its own balanced
// range of history pages in tiles of 32 keys (one warp's width, so the
// online-softmax update of a row is one warp reduction) and writes its
// partial (m, l, acc) to scratch.  A second launch (split_merge.cuh, shared
// with B1 and B2) merges the splits and writes `out`.  The wrapper picks
// the split count so that about two blocks per SM are in flight, capped by
// the pages a lane can hold; a block whose range is empty writes l = 0 and
// the merge skips it.
//
// The hazard the TPU kernel avoided by program order within a lane: here
// the splits of one lane run in parallel.  History keys (positions below
// pos0) are read from the pages, which this launch never writes; the
// window's own keys are read straight from k_new / v_new by the one
// designated split (the last), which also writes them into the pages.  So
// no block reads a page position that this launch writes.  Pages written
// for a lane are exclusive to it after the engine's copy-on-write barrier.
//
// Semantics kept from the TPU kernel: masked scores are NEG_INF = -1e30,
// the softmax denominator is floored at 1e-30, accumulation is float32.
// Masked keys contribute exactly 0 (explicitly, not through exp of -1e30),
// so a split that sees no valid key for a row carries l = 0.
#include <cuda_runtime.h>

#include "split_merge.cuh"

namespace {

using repro_split::kNegInf;
using repro_split::warp_max;
using repro_split::warp_sum;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;  // keys per tile: one per lane of a warp

__global__ void paged_verify_split_kernel(
    const float* __restrict__ q,        // (B, S, H, hd)
    const float* __restrict__ k_new,    // (B, S, KVH, hd)
    const float* __restrict__ v_new,
    float* __restrict__ k_pages,        // (n_pages, page, KVH, hd)
    float* __restrict__ v_pages,
    const int* __restrict__ block_table,  // (B, max_pages)
    const int* __restrict__ pos0_arr,     // (B,)
    const int* __restrict__ clen_arr,     // (B,)
    float* __restrict__ m_ws,             // (B, KVH, n_split, S * G)
    float* __restrict__ l_ws,             // (B, KVH, n_split, S * G)
    float* __restrict__ acc_ws,           // (B, KVH, n_split, S * G, hd)
    int S, int H, int KVH, int hd, int page, int max_pages, float scale,
    int window, int n_split) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ks = hd + 1;                 // padded K row: no bank conflicts
  const int n4 = hd >> 2;                // float4s per row
  const int pos0 = pos0_arr[b];
  const int n_tok = clen_arr[b];
  if (n_tok <= 0) return;                // masked lane: no write, no rows
  const bool own = split == n_split - 1; // designated split
  const long long row = (long long)KVH * hd;  // floats per token slot
  const long long ws_base = (((long long)b * KVH + kvh) * n_split + split)
                            * (long long)(S * G);

  // ---- the window's rows into the pages (designated split, own head) ----
  if (own) {
    for (int e = tid; e < n_tok * n4; e += kThreads) {
      const int i = e / n4, d4 = e % n4;
      const int pos = pos0 + i;
      const int slot = pos / page;
      if (slot >= max_pages) continue;
      const long long pid = block_table[(long long)b * max_pages + slot];
      const long long dst = (pid * page + pos % page) * row + (long long)kvh * hd;
      const long long src = ((long long)b * S + i) * row + (long long)kvh * hd;
      reinterpret_cast<float4*>(k_pages + dst)[d4] =
          reinterpret_cast<const float4*>(k_new + src)[d4];
      reinterpret_cast<float4*>(v_pages + dst)[d4] =
          reinterpret_cast<const float4*>(v_new + src)[d4];
    }
  }

  // ---- this split's history range: balanced over pages ----
  int h_lo = 0;
  if (window > 0) h_lo = max(0, pos0 - window + 1);
  const int pg_lo = h_lo / page;
  const int n_pg = max((pos0 + page - 1) / page - pg_lo, 0);
  const int my_lo = pg_lo + (int)((long long)split * n_pg / n_split);
  const int my_hi = pg_lo + (int)((long long)(split + 1) * n_pg / n_split);
  const int k_begin = max(h_lo, my_lo * page);
  const int n_hist = max(min(pos0, my_hi * page) - k_begin, 0);
  const int n_keys = n_hist + (own ? n_tok : 0);
  const int R_live = n_tok * G;          // live rows, position-major

  if (n_keys == 0) {  // the merge reads acc with weight 0: write zeros
    for (int r = tid; r < R_live; r += kThreads) {
      m_ws[ws_base + r] = kNegInf;
      l_ws[ws_base + r] = 0.f;
    }
    for (int e = tid; e < R_live * hd; e += kThreads)
      acc_ws[ws_base * hd + e] = 0.f;
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;                     // R * hd
  float* acc = q_s + S * G * hd;         // R * hd
  float* v_s = acc + S * G * hd;         // kTK * hd (float4 aligned)
  float* k_s = v_s + kTK * hd;           // kTK * (hd + 1)
  float* p_s = k_s + kTK * ks;           // R * kTK
  float* m_s = p_s + S * G * kTK;        // R
  float* l_s = m_s + S * G;              // R
  float* a_s = l_s + S * G;              // R

  for (int e = tid; e < R_live * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const int i = r / G, g = r % G;
    q_s[e] = q[(((long long)b * S + i) * H + (long long)kvh * G + g) * hd + d];
    acc[e] = 0.f;
  }
  for (int r = tid; r < R_live; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  for (int t0 = 0; t0 < n_keys; t0 += kTK) {
    __syncthreads();  // previous tile's k_s / v_s / p_s consumed
    for (int e = tid; e < kTK * n4; e += kThreads) {
      const int p = e / n4, d4 = e % n4;
      const int t = t0 + p;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (t < n_hist) {        // history: pages this launch never writes
        const int pos = k_begin + t;
        const long long pid =
            block_table[(long long)b * max_pages + pos / page];
        const long long off = (pid * page + pos % page) * row + (long long)kvh * hd;
        kv = reinterpret_cast<const float4*>(k_pages + off)[d4];
        vv = reinterpret_cast<const float4*>(v_pages + off)[d4];
      } else if (t < n_keys) { // the window's own keys: from k_new / v_new
        const long long off =
            ((long long)b * S + (t - n_hist)) * row + (long long)kvh * hd;
        kv = reinterpret_cast<const float4*>(k_new + off)[d4];
        vv = reinterpret_cast<const float4*>(v_new + off)[d4];
      }
      float* kd = k_s + p * ks + 4 * d4;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      reinterpret_cast<float4*>(v_s + p * hd)[d4] = vv;
    }
    __syncthreads();
    for (int e = tid; e < R_live * kTK; e += kThreads) {
      const int r = e / kTK, p = e % kTK;
      const int t = t0 + p;
      const int i = r / G;
      bool valid;
      if (t < n_hist) {
        valid = window <= 0 || k_begin + t > pos0 + i - window;
      } else if (t < n_keys) {
        const int j = t - n_hist;
        valid = j <= i && (window <= 0 || j > i - window);
      } else {
        valid = false;
      }
      float s = kNegInf;
      if (valid) {
        const float* qr = q_s + r * hd;
        const float* kr = k_s + p * ks;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      p_s[e] = s;
    }
    __syncthreads();
    for (int r = warp; r < R_live; r += kWarps) {  // one warp per row
      const float s = p_s[r * kTK + lane];
      const bool valid = s > 0.5f * kNegInf;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(valid ? s : kNegInf));
      const float e = valid ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(e);
      p_s[r * kTK + lane] = e;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();
    for (int e = tid; e < R_live * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const float* pr = p_s + r * kTK;
      float pv = 0.f;
#pragma unroll 8
      for (int p = 0; p < kTK; ++p) pv += pr[p] * v_s[p * hd + d];
      acc[e] = acc[e] * a_s[r] + pv;
    }
  }
  __syncthreads();
  for (int r = tid; r < R_live; r += kThreads) {
    m_ws[ws_base + r] = m_s[r];
    l_ws[ws_base + r] = l_s[r];
  }
  for (int e = tid; e < R_live * hd; e += kThreads)
    acc_ws[ws_base * hd + e] = acc[e];
}

}  // namespace

extern "C" int repro_paged_verify_f32(
    const float* q, const float* k_new, const float* v_new, float* k_pages,
    float* v_pages, const int* block_table, const int* pos0,
    const int* chunk_len, float* m_ws, float* l_ws, float* acc_ws,
    float* out, int B, int S, int H, int KVH, int hd, int page,
    int max_pages, float scale, int window, int n_split, void* stream) {
  const int G = H / KVH;
  const int R = S * G;
  const size_t smem = sizeof(float) *
      (size_t)(2 * R * hd + kTK * hd + kTK * (hd + 1) + R * kTK + 3 * R);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_verify_split_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  paged_verify_split_kernel<<<dim3(B, KVH, n_split), kThreads, smem, st>>>(
      q, k_new, v_new, k_pages, v_pages, block_table, pos0, chunk_len, m_ws,
      l_ws, acc_ws, S, H, KVH, hd, page, max_pages, scale, window, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return repro_split::launch_split_merge(m_ws, l_ws, acc_ws, chunk_len, out,
                                        B, S, H, KVH, hd, n_split, st);
}
