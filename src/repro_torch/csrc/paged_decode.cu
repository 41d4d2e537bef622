// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (Pallas body _paged_kernel).  One query token per lane attends over its
// KV history scattered across pages addressed by a block table, with an
// online softmax and an optional sliding window.
//
// What bounds it on an H100: bytes.  Each (lane, KV head) reads its K/V
// history once and does 4*G*hd flops per key (G = query heads per KV head,
// 1 to 4 on the port's paths), far below the float32 ridge, so the floor is
// the visible K/V bytes over 3.35 TB/s: a few microseconds for eight lanes
// of up to 2k keys.  Reaching it takes many bytes in flight on every SM.
//
// What the design does about it:
// - Grid (lane, KV head, key split).  The wrapper picks the split count on
//   the host, without a sync, so that about two blocks per SM are in flight
//   (capped by the table width or the window's pages).  Each split takes a
//   balanced share of the lane's own pages [lo, ceil(seq_len / page)), so
//   the longest lane no longer sets the time.  A split whose share is empty
//   writes l = 0; a second launch (split_merge.cuh) merges the splits.  With
//   one split the block writes the output itself.
// - No block barrier per page.  A key row of one KV head is hd contiguous
//   floats, hd / 4 float4 columns; a stream of LPK lanes (hd / 4 rounded up
//   to a power of two) reads it one float4 a lane, so a warp holds 32 /
//   LPK independent key streams.  Each stream keeps U keys' K and V rows
//   in flight (16-byte loads), scores them against the G query rows it
//   holds in registers (a dot product reduced over its LPK lanes by
//   shuffles) and folds them into its own running (m, l, acc).  At a head
//   dim whose hd / 4 is no power of two (zamba2's 112: 28 columns) the
//   stream's last lanes (4 of 32) hold zeros: they load nothing, add 0 to
//   every dot product and store nothing, so the shuffles stay at powers
//   of two.  The block's streams are merged once, at the end, through
//   shared memory.
// - The window's lower bound skips pages wholly below seq_len - window, and
//   pages past the end are never read (every decode lane has seq_len >= 1).
//
// Semantics kept from the TPU kernel: masked scores are NEG_INF = -1e30
// (they contribute exactly 0), the denominator is floored at 1e-30, all
// accumulation is float32.
#include <cuda_runtime.h>

#include "split_merge.cuh"

namespace {

using repro_split::kNegInf;

// lanes a key row of c4 float4 columns takes: c4 rounded up to a power of
// two (8 at head dim 32, 16 at 64, 32 at 112 and 128)
__host__ __device__ constexpr int lanes_per_row(int c4) {
  return c4 <= 8 ? 8 : c4 <= 16 ? 16 : 32;
}

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kU = 8;  // keys in flight per stream

template <int HD, int MG>  // head dim; largest group size G the build takes
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q,          // (B, H, hd)
    const float* __restrict__ k_pages,    // (n_pages, page, KVH, hd)
    const float* __restrict__ v_pages,
    const int* __restrict__ block_table,  // (B, max_pages)
    const int* __restrict__ seq_lens,     // (B,)
    float* __restrict__ out,              // (B, H, hd)      one split
    float* __restrict__ m_ws,             // (B, KVH, n_split, G)
    float* __restrict__ l_ws,
    float* __restrict__ acc_ws,           // (B, KVH, n_split, G, hd)
    int H, int KVH, int page, int max_pages, float scale, int window,
    int n_split) {
  constexpr int C4 = HD / 4;           // float4 columns of a key row
  constexpr int LPK = lanes_per_row(C4);  // lanes per key row (float4 each)
  constexpr int KPW = 32 / LPK;        // key streams per warp
  constexpr int NS = kWarps * KPW;     // key streams per block
  static_assert(HD % 4 == 0 && C4 <= 32, "a key row is at most 32 float4s");
  __shared__ float m_s[NS][MG];
  __shared__ float l_s[NS][MG];
  __shared__ float4 acc_s[NS][MG][C4];

  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int G = H / KVH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane % LPK;                       // float4 column
  const bool col = LPK == C4 || li < C4;           // the lane holds a column
  const int stream = warp * KPW + lane / LPK;
  const long long row4 = (long long)KVH * C4;      // float4s per token slot

  // this split's share of the lane's pages
  const int seq_len = seq_lens[b];
  const int key_lo = window > 0 ? max(seq_len - window, 0) : 0;
  const int pg_lo = key_lo / page;
  const int pg_hi = min((seq_len + page - 1) / page, max_pages);
  const int n_pg = max(pg_hi - pg_lo, 0);
  const int my_lo = pg_lo + (int)((long long)split * n_pg / n_split);
  const int my_hi = pg_lo + (int)((long long)(split + 1) * n_pg / n_split);
  const int k_begin = max(key_lo, my_lo * page);
  const int k_end = min(seq_len, my_hi * page);

  float4 qv[MG];
  float m[MG], l[MG];
  float4 acc[MG];
  const float4* q4 = reinterpret_cast<const float4*>(q) +
                     ((long long)b * H + (long long)kvh * G) * C4 + li;
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    qv[g] = g < G && col ? q4[g * C4] : make_float4(0.f, 0.f, 0.f, 0.f);
    m[g] = kNegInf;
    l[g] = 0.f;
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float4* k4 = reinterpret_cast<const float4*>(k_pages) + (long long)kvh * C4 + li;
  const float4* v4 = reinterpret_cast<const float4*>(v_pages) + (long long)kvh * C4 + li;
  const int* bt = block_table + (long long)b * max_pages;
  // the loop is uniform over the warp (its shuffles need every lane); a
  // stream past the end masks all its keys
  for (int kw = k_begin + warp * KPW * kU; kw < k_end; kw += NS * kU) {
    const int k0 = kw + (lane / LPK) * kU;
    float4 kr[kU], vr[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int pos = k0 + u;
      if (pos < k_end && col) {
        const long long slot = (long long)bt[pos / page] * page + pos % page;
        kr[u] = __ldg(k4 + slot * row4);
        vr[u] = __ldg(v4 + slot * row4);
      } else {
        kr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vr[u] = kr[u];
      }
    }
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g >= G) break;
      float s[kU];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float d = qv[g].x * kr[u].x + qv[g].y * kr[u].y + qv[g].z * kr[u].z +
                  qv[g].w * kr[u].w;
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        s[u] = k0 + u < k_end ? d * scale : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[g] - mx);
      float sum = 0.f;
      float4 a = make_float4(acc[g].x * alpha, acc[g].y * alpha,
                             acc[g].z * alpha, acc[g].w * alpha);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float p = k0 + u < k_end ? expf(s[u] - mx) : 0.f;
        sum += p;
        a.x += p * vr[u].x;
        a.y += p * vr[u].y;
        a.z += p * vr[u].z;
        a.w += p * vr[u].w;
      }
      acc[g] = a;
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
    }
  }

  // merge the block's streams: every lane of a stream holds the same (m, l)
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (col) acc_s[stream][g][li] = acc[g];
    if (li == 0) {
      m_s[stream][g] = m[g];
      l_s[stream][g] = l[g];
    }
  }
  __syncthreads();
  const long long ws_row = (((long long)b * KVH + kvh) * n_split + split) * G;
  for (int e = threadIdx.x; e < G * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    float mx = kNegInf;
    for (int t = 0; t < NS; ++t)
      if (l_s[t][g] > 0.f) mx = fmaxf(mx, m_s[t][g]);
    float den = 0.f, num = 0.f;
    for (int t = 0; t < NS; ++t) {
      const float lt = l_s[t][g];
      if (lt > 0.f) {
        const float c = expf(m_s[t][g] - mx);
        den += lt * c;
        num += reinterpret_cast<const float*>(&acc_s[t][g][0])[d] * c;
      }
    }
    if (n_split == 1) {
      out[((long long)b * H + (long long)kvh * G + g) * HD + d] =
          num / fmaxf(den, 1e-30f);
    } else {
      acc_ws[(ws_row + g) * HD + d] = num;
      if (d == 0) {
        m_ws[ws_row + g] = mx;
        l_ws[ws_row + g] = den;
      }
    }
  }
}

template <int HD, int MG>
int launch(const float* q, const float* k_pages, const float* v_pages,
           const int* block_table, const int* seq_lens, float* out,
           float* m_ws, float* l_ws, float* acc_ws, int B, int H, int KVH,
           int page, int max_pages, float scale, int window, int n_split,
           cudaStream_t st) {
  paged_decode_kernel<HD, MG><<<dim3(B, KVH, n_split), kThreads, 0, st>>>(
      q, k_pages, v_pages, block_table, seq_lens, out, m_ws, l_ws, acc_ws, H,
      KVH, page, max_pages, scale, window, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return repro_split::launch_split_merge(m_ws, l_ws, acc_ws, nullptr, out, B,
                                         1, H, KVH, HD, n_split, st);
}

template <int HD>
int launch_hd(int G, const float* q, const float* k_pages,
              const float* v_pages, const int* block_table,
              const int* seq_lens, float* out, float* m_ws, float* l_ws,
              float* acc_ws, int B, int H, int KVH, int page, int max_pages,
              float scale, int window, int n_split, cudaStream_t st) {
#define REPRO_DECODE_LAUNCH(MG)                                              \
  return launch<HD, MG>(q, k_pages, v_pages, block_table, seq_lens, out,    \
                        m_ws, l_ws, acc_ws, B, H, KVH, page, max_pages,     \
                        scale, window, n_split, st)
  if (G <= 1) REPRO_DECODE_LAUNCH(1);
  if (G <= 2) REPRO_DECODE_LAUNCH(2);
  if (G <= 4) REPRO_DECODE_LAUNCH(4);
  if (G <= 8) REPRO_DECODE_LAUNCH(8);
#undef REPRO_DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns 0 or a CUDA error code; cudaErrorInvalidValue (1) for a head dim
// other than 32, 64, 112, 128 or a group larger than 8 (the wrapper
// refuses both first).
extern "C" int repro_paged_decode_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* block_table, const int* seq_lens, float* out, float* m_ws,
    float* l_ws, float* acc_ws, int B, int H, int KVH, int hd, int page,
    int max_pages, float scale, int window, int n_split, void* stream) {
  const int G = H / KVH;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_hd<32>(G, q, k_pages, v_pages, block_table, seq_lens, out,
                           m_ws, l_ws, acc_ws, B, H, KVH, page, max_pages,
                           scale, window, n_split, st);
    case 64:
      return launch_hd<64>(G, q, k_pages, v_pages, block_table, seq_lens, out,
                           m_ws, l_ws, acc_ws, B, H, KVH, page, max_pages,
                           scale, window, n_split, st);
    case 112:
      return launch_hd<112>(G, q, k_pages, v_pages, block_table, seq_lens,
                            out, m_ws, l_ws, acc_ws, B, H, KVH, page,
                            max_pages, scale, window, n_split, st);
    case 128:
      return launch_hd<128>(G, q, k_pages, v_pages, block_table, seq_lens,
                            out, m_ws, l_ws, acc_ws, B, H, KVH, page,
                            max_pages, scale, window, n_split, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
