// Merge of key-split partial attention results, shared by the paged decode
// (B1, csrc/paged_decode.cu), fused paged prefill (B2,
// csrc/paged_prefill.cu), paged verify (B3, csrc/paged_verify.cu), MLA
// latent-page prefill (B4, csrc/mla_paged_prefill.cu; KVH 1, G = H,
// hd = r) and dense flash attention (B6, csrc/flash_attention.cu; B = BH,
// S = Sq, H = KVH = 1) kernels.
//
// A kernel that splits each (lane, KV head)'s keys over n_split blocks
// writes, per split s and per query row r of the (lane, KV head) group,
// its running max m, its softmax denominator l (0 when the split saw no
// valid key for the row) and its unnormalised accumulator acc:
//   m_ws, l_ws: (B, KVH, n_split, R)      acc_ws: (B, KVH, n_split, R, hd)
// with R = S * G rows, position-major (row r = i * G + g for position i
// and group member g).  This launch writes
//   out[b, i, h, :] = sum_s acc_s * exp(m_s - M) / max(sum_s l_s * exp(m_s - M), 1e-30)
// over the splits with l_s > 0, M = max of their m_s, for out (B, S, H, hd)
// (decode passes S = 1), float32 or bf16 (B1's bf16 queries, B6's bf16
// inputs: each element rounded once from the fp32 merge).  Rows i >=
// clen[b] are zeros; clen may be null (every row live).
#pragma once
#include <cuda_runtime.h>

#include "page_types.cuh"

namespace repro_split {

constexpr float kNegInf = -1e30f;
constexpr int kMergeThreads = 128;   // one block per output row

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The merge's arithmetic, shared with B3's in-kernel merge
// (csrc/paged_verify.cu): a split's weight exp(m_s - M), 0 for a split that
// saw no valid key for the row (l_s = 0), and 1 / the merged denominator,
// floored at 1e-30.
__device__ __forceinline__ float split_weight(float m, float l, float mx) {
  return l > 0.f ? expf(m - mx) : 0.f;
}

__device__ __forceinline__ float inv_denominator(float den) {
  return 1.f / fmaxf(den, 1e-30f);
}

// max (is_max) or sum of v over the block; red holds kMergeThreads / 32
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();                       // red free from a previous use
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kMergeThreads / 32; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// One block per output row (b, i, h).  The splits' weights exp(m_s - M)
// are computed once, in parallel, into shared memory; then the block's
// threads take (split slice, float4 column) pairs, so the loads of the
// splits' accumulator rows are independent and coalesced, and the slices
// are summed through shared memory.  (A warp per row, with no block
// barrier, took twice as long on an H100 at 64 to 88 splits, and a split
// of a 512-row chunk gained 10% at most with it: PERF.md, section 6.)
// Every split writes its accumulator rows for the rows it covers (zeros
// when its share is empty), so the weighted sum reads no unwritten memory.
template <typename OT>
__global__ void __launch_bounds__(kMergeThreads) split_merge_kernel(
    const float* __restrict__ m_ws, const float* __restrict__ l_ws,
    const float* __restrict__ acc_ws, const int* __restrict__ clen,
    OT* __restrict__ out, int S, int H, int KVH, int hd, int n_split) {
  extern __shared__ float4 w_s4[];       // n_split weights, then the slices
  float* w_s = reinterpret_cast<float*>(w_s4);
  __shared__ float red[kMergeThreads / 32];
  const int row = blockIdx.x;            // 32-bit: a 64-bit divide spills
  const int h = row % H;
  const int i = (row / H) % S;
  const int b = row / (H * S);
  const int tid = threadIdx.x;
  OT* ob = out + (long long)row * hd;
  if (clen != nullptr && i >= clen[b]) {
    for (int d = tid; d < hd; d += kMergeThreads)
      repro_page::store1(ob + d, 0.f);
    return;
  }
  const int G = H / KVH;
  const int R = S * G;
  const long long base =
      ((long long)b * KVH + h / G) * n_split * R + (long long)i * G + h % G;
  float mx = kNegInf;
  for (int s = tid; s < n_split; s += kMergeThreads) {
    const long long w = base + (long long)s * R;
    if (l_ws[w] > 0.f) mx = fmaxf(mx, m_ws[w]);
  }
  mx = block_reduce(mx, red, true);
  float den = 0.f;
  for (int s = tid; s < n_split; s += kMergeThreads) {
    const long long w = base + (long long)s * R;
    const float l = l_ws[w];
    const float c = split_weight(m_ws[w], l, mx);
    w_s[s] = c;
    den += l * c;
  }
  const float inv = inv_denominator(block_reduce(den, red, false));  // publishes w_s
  const int c4 = hd / 4;
  const int slices = kMergeThreads / c4;
  const int col = tid % c4, slice = tid / c4;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (slice < slices) {
#pragma unroll 4
    for (int s = slice; s < n_split; s += slices) {
      const float c = w_s[s];
      const float4 v = reinterpret_cast<const float4*>(
          acc_ws + (base + (long long)s * R) * hd)[col];
      a.x += v.x * c;
      a.y += v.y * c;
      a.z += v.z * c;
      a.w += v.w * c;
    }
  }
  float4* part = reinterpret_cast<float4*>(w_s + ((n_split + 3) & ~3));
  if (slice < slices) part[slice * c4 + col] = a;
  __syncthreads();
  if (tid < c4) {
    float4 t = part[tid];
    for (int k = 1; k < slices; ++k) {
      const float4 v = part[k * c4 + tid];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    repro_page::store4(ob + 4 * tid, make_float4(t.x * inv, t.y * inv,
                                                 t.z * inv, t.w * inv));
  }
}

// Launch the merge on `stream`; returns the CUDA error code (0 on success).
// hd must be a multiple of 4 and at most 4 * kMergeThreads, the rows
// aligned to 4 elements, and B * S * H below 2^31.
template <typename OT>
int launch_split_merge(const float* m_ws, const float* l_ws,
                       const float* acc_ws, const int* clen, OT* out, int B,
                       int S, int H, int KVH, int hd, int n_split,
                       cudaStream_t stream) {
  const int slices = kMergeThreads / (hd / 4);
  const size_t smem =
      sizeof(float) * ((size_t)((n_split + 3) & ~3) + (size_t)slices * hd);
  split_merge_kernel<OT><<<(unsigned)((long long)B * S * H), kMergeThreads,
                           smem, stream>>>(m_ws, l_ws, acc_ws, clen, out, S,
                                           H, KVH, hd, n_split);
  return (int)cudaGetLastError();
}

}  // namespace repro_split
