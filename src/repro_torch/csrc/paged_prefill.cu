// Fused chunked-prefill paged attention for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/paged_prefill.py, paged_prefill_attention
// (Pallas body _prefill_kernel).  One launch per layer per prefill group
// does what the unfused path spreads over three ops:
//   phase 1  writes the chunk's K/V rows into the lane's pool pages
//            (row i lands at position pos0[b] + i, only for i < chunk_len[b];
//            a lane with chunk_len 0 writes nothing), in place;
//   phase 2  runs causal (and sliding-window) flash attention for the
//            chunk's queries over the paged history plus the chunk itself.
//
// What bounds it on an H100: at the main path's shapes (chunks of hundreds
// of tokens over a history of up to a few thousand) the work is
// O(S * kv_len * H * hd) flops on O((S + kv_len) * KVH * hd) bytes, well
// above the float32 ridge, so it is bound by operations: float32 FMAs
// outside the tensor cores in this simple version (67 TFLOP/s peak).
//
// What the design does about it: the grid is (lane, KV head, query tile),
// so a 512-token chunk spreads over 32 tiles per (lane, KV head) instead of
// one block, and each tile stops its key loop at its own last query
// (causal), skipping the upper triangle.  Each block holds the whole GQA
// group of its query positions, so a staged K/V block serves G heads.
// Tensor-core (wgmma, tf32/bf16) products are work for a later version.
//
// The hazard the TPU kernel avoided by program order within a lane
// (paged_prefill.py, "Pallas guarantees program order within a lane"):
// here the tiles of one lane run in parallel, so no block ever reads a
// page position that another block may be writing.  Keys at positions
// below pos0 (the history) are read from the pages, which this launch
// never writes; keys of the chunk itself (positions >= pos0) are read
// straight from k_new / v_new.  Each tile writes only its own positions,
// and only its own KV head's slice of each page, so writes are disjoint.
// Pages written by different lanes are exclusive after the engine's
// copy-on-write barrier (PagedKVManager.ensure_writable).
//
// Output rows at i >= chunk_len[b] (padding) are written as zeros.  Masked
// scores are NEG_INF = -1e30 and the denominator is floored at 1e-30, as
// in the TPU kernel.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__global__ void paged_prefill_kernel(
    const float* __restrict__ q,        // (B, S, H, hd)
    const float* __restrict__ k_new,    // (B, S, KVH, hd)
    const float* __restrict__ v_new,
    float* __restrict__ k_pages,        // (n_pages, page, KVH, hd)
    float* __restrict__ v_pages,
    const int* __restrict__ block_table,  // (B, max_pages)
    const int* __restrict__ pos0_arr,     // (B,)
    const int* __restrict__ clen_arr,     // (B,)
    float* __restrict__ out,              // (B, S, H, hd)
    int S, int H, int KVH, int hd, int page, int max_pages, float scale,
    int window, int tq) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int t0 = blockIdx.z * tq;       // first query position of the tile
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int R = tq * G;                 // query rows (position-major)
  const int ks = hd + 1;
  const int pos0 = pos0_arr[b];
  const int n_tok = clen_arr[b];
  const long long row = (long long)KVH * hd;   // floats per token slot
  const int t_end = min(t0 + tq, S);           // tile's positions [t0, t_end)
  const int n_live = max(min(t_end, n_tok) - t0, 0);  // unpadded positions

  // ---- phase 1: this tile's chunk rows into the pages (own head only) ----
  for (int e = tid; e < n_live * hd; e += kThreads) {
    const int i = t0 + e / hd, d = e % hd;
    const int pos = pos0 + i;
    const int slot = pos / page;
    if (slot >= max_pages) continue;
    const long long pid = block_table[(long long)b * max_pages + slot];
    const long long dst = (pid * page + pos % page) * row + (long long)kvh * hd + d;
    const long long src = ((long long)b * S + i) * row + (long long)kvh * hd + d;
    k_pages[dst] = k_new[src];
    v_pages[dst] = v_new[src];
  }

  // ---- zero the padded rows of this tile ----
  for (int e = tid; e < (t_end - t0 - n_live) * G * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const int i = t0 + n_live + r / G, g = r % G;
    out[(((long long)b * S + i) * H + (long long)kvh * G + g) * hd + d] = 0.f;
  }
  if (n_live == 0) return;

  extern __shared__ float smem[];
  float* q_s = smem;                 // R * hd
  float* acc = q_s + R * hd;         // R * hd
  float* k_s = acc + R * hd;         // page * (hd + 1)
  float* v_s = k_s + page * ks;      // page * hd
  float* s_s = v_s + page * hd;      // R * page
  float* m_s = s_s + R * page;       // R
  float* l_s = m_s + R;              // R
  float* a_s = l_s + R;              // R

  const int R_live = n_live * G;
  for (int e = tid; e < R_live * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const int i = t0 + r / G, g = r % G;
    q_s[e] = q[(((long long)b * S + i) * H + (long long)kvh * G + g) * hd + d];
    acc[e] = 0.f;
  }
  for (int r = tid; r < R_live; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // key range: the tile's first query sees back to q_pos - window + 1, its
  // last live query up to pos0 + t0 + n_live - 1
  const int q_first = pos0 + t0;
  const int q_last = pos0 + t0 + n_live - 1;
  int lo = 0;
  if (window > 0) {
    const int first_key = q_first - window + 1;
    lo = first_key > 0 ? first_key / page : 0;
  }
  int hi = q_last / page + 1;
  if (hi > max_pages) hi = max_pages;
  const int kv_len = pos0 + n_tok;

  for (int pg = lo; pg < hi; ++pg) {
    const long long pid = block_table[(long long)b * max_pages + pg];
    __syncthreads();  // previous block's k_s / v_s / s_s consumed
    for (int e = tid; e < page * hd; e += kThreads) {
      const int p = e / hd, d = e % hd;
      const int pos = pg * page + p;
      float kv = 0.f, vv = 0.f;
      if (pos < pos0) {  // history: pages this launch never writes
        const long long off = (pid * page + p) * row + (long long)kvh * hd + d;
        kv = k_pages[off];
        vv = v_pages[off];
      } else if (pos < kv_len) {  // the chunk itself: from k_new / v_new
        const long long off =
            ((long long)b * S + (pos - pos0)) * row + (long long)kvh * hd + d;
        kv = k_new[off];
        vv = v_new[off];
      }
      k_s[p * ks + d] = kv;
      v_s[e] = vv;
    }
    __syncthreads();
    for (int e = tid; e < R_live * page; e += kThreads) {
      const int r = e / page, p = e % page;
      const float* qr = q_s + r * hd;
      const float* kr = k_s + p * ks;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
      const int k_pos = pg * page + p;
      const int q_pos = q_first + r / G;
      bool valid = (k_pos < kv_len) && (k_pos <= q_pos);
      if (window > 0) valid = valid && (k_pos > q_pos - window);
      s_s[e] = valid ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int r = tid; r < R_live; r += kThreads) {
      float* sr = s_s + r * page;
      const float m_old = m_s[r];
      float m_new = m_old;
      for (int p = 0; p < page; ++p) m_new = fmaxf(m_new, sr[p]);
      float sum = 0.f;
      for (int p = 0; p < page; ++p) {
        const float e = expf(sr[p] - m_new);
        sr[p] = e;
        sum += e;
      }
      const float alpha = expf(m_old - m_new);
      a_s[r] = alpha;
      m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + sum;
    }
    __syncthreads();
    for (int e = tid; e < R_live * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const float* pr = s_s + r * page;
      float pv = 0.f;
      for (int p = 0; p < page; ++p) pv += pr[p] * v_s[p * hd + d];
      acc[e] = acc[e] * a_s[r] + pv;
    }
  }
  __syncthreads();
  for (int e = tid; e < R_live * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const int i = t0 + r / G, g = r % G;
    out[(((long long)b * S + i) * H + (long long)kvh * G + g) * hd + d] =
        acc[e] / fmaxf(l_s[r], 1e-30f);
  }
}

}  // namespace

extern "C" int repro_paged_prefill_f32(
    const float* q, const float* k_new, const float* v_new, float* k_pages,
    float* v_pages, const int* block_table, const int* pos0,
    const int* chunk_len, float* out, int B, int S, int H, int KVH, int hd,
    int page, int max_pages, float scale, int window, int tq, void* stream) {
  const int G = H / KVH;
  const int R = tq * G;
  const size_t smem = sizeof(float) *
      (size_t)(2 * R * hd + page * (hd + 1) + page * hd + R * page + 3 * R);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, KVH, (S + tq - 1) / tq);
  paged_prefill_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, k_new, v_new, k_pages, v_pages, block_table, pos0, chunk_len, out,
      S, H, KVH, hd, page, max_pages, scale, window, tq);
  return (int)cudaGetLastError();
}
