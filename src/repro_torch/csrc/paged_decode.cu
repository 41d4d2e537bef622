// Paged decode attention for Hopper (sm_90a), float32, bfloat16 or float16
// pages; float32 queries and output, or bf16 ones over bf16 pages.
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
// of up to 2k keys (half that over bf16 pages).  Reaching it takes many
// bytes in flight on every SM.
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
//   elements, cut into 16-byte columns: hd / 4 in float32, hd / 8 in
//   bf16.  A stream of LPK lanes (the columns rounded up to a power of
//   two) reads it one column a lane, so a warp holds 32 / LPK independent
//   key streams.  Each stream keeps U keys' K and V rows in flight (16-byte
//   loads; U = 8, 4 at bf16's group of 8, whose q and accumulators take 8
//   floats a lane per row), scores them against the G query rows it holds
//   in registers (a dot product reduced over its LPK lanes by shuffles)
//   and folds them into its own running (m, l, acc).  At a head dim whose
//   column count is no power of two (zamba2's 112: 28 columns in float32,
//   14 in bf16) the stream's last lanes hold zeros: they load nothing,
//   add 0 to every dot product and store nothing, so the shuffles stay at
//   powers of two.  The block's streams are merged once, at the end,
//   through shared memory.
// - The window's lower bound skips pages wholly below seq_len - window, and
//   pages past the end are never read (every decode lane has seq_len >= 1).
// - bf16 pages (page_types.cuh): a column holds 8 elements, so a row takes
//   half the lanes and a warp twice the key streams, with as many bytes in
//   flight per load as in float32; a lane widens its elements to fp32 in
//   registers as it uses them (the high half of an fp32 word: a shift or
//   a mask).  A first design kept float32's four elements a lane (8-byte
//   loads): it ran 1.4x float32's time on an H100 (PERF.md).
// - float16 pages: the same 16-byte columns of 8 elements; an fp16 element
//   has no such bit trick and is converted (cvt.f32.f16, exact) as it is
//   used.
// - bf16 queries over bf16 pages (the reference's all-bf16 case,
//   tests/test_kernels.py): q is widened to fp32 as it is loaded, the
//   arithmetic is the float32 kernel's, and the output is rounded to bf16
//   once, from the fp32 result (split_merge.cuh rounds it when the keys
//   are split).  No engine path passes it: its activations are float32.
//
// Semantics kept from the TPU kernel: masked scores are NEG_INF = -1e30
// (they contribute exactly 0), the denominator is floored at 1e-30, all
// accumulation is float32.
#include <cuda_runtime.h>

#include "page_types.cuh"
#include "split_merge.cuh"

namespace {

using repro_page::bf16;
using repro_page::f16;
using repro_page::load4;
using repro_page::store1;
using repro_split::kNegInf;

// lanes a key row of c 16-byte columns takes: c rounded up to a power of
// two, at least 4 (float32: 8 at head dim 32, 16 at 64, 32 at 112 and
// 128; bf16: 4, 8, 16 and 16)
__host__ __device__ constexpr int lanes_per_row(int c) {
  return c <= 4 ? 4 : c <= 8 ? 8 : c <= 16 ? 16 : 32;
}

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kU = 8;  // keys in flight per stream

// element i of a 16-byte column of T values, as fp32 (bf16 is the high
// half of an fp32 word: a shift or a mask; fp16 a conversion; both exact)
template <typename T>
__device__ __forceinline__ float elem(const uint4& c, int i) {
  const uint32_t w = (&c.x)[sizeof(T) == 4 ? i : i / 2];
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else if constexpr (std::is_same_v<T, bf16>) {
    return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
  } else {
    return __half2float(
        __ushort_as_half((unsigned short)(i % 2 ? w >> 16 : w)));
  }
}

// T: page element type; Q: query and output type (float, or bf16 over bf16
// pages); head dim; largest group size G the build takes
template <typename T, typename Q, int HD, int MG>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const Q* __restrict__ q,              // (B, H, hd)
    const T* __restrict__ k_pages,        // (n_pages, page, KVH, hd)
    const T* __restrict__ v_pages,
    const int* __restrict__ block_table,  // (B, max_pages)
    const int* __restrict__ seq_lens,     // (B,)
    Q* __restrict__ out,                  // (B, H, hd)      one split
    float* __restrict__ m_ws,             // (B, KVH, n_split, G)
    float* __restrict__ l_ws,
    float* __restrict__ acc_ws,           // (B, KVH, n_split, G, hd)
    int H, int KVH, int page, int max_pages, float scale, int window,
    int n_split) {
  constexpr int EPL = repro_page::kPerChunk<T>;  // elements of a column
  constexpr int C = HD / EPL;          // 16-byte columns of a key row
  constexpr int LPK = lanes_per_row(C);  // lanes per key row (a column each)
  constexpr int KPW = 32 / LPK;        // key streams per warp
  constexpr int NS = kWarps * KPW;     // key streams per block
  // keys in flight per stream: half at bf16's widest group, whose q and
  // accumulators take 8 floats a lane per query row
  constexpr int U = MG * EPL > 32 ? kU / 2 : kU;
  static_assert(HD % EPL == 0 && C <= 32, "a key row is at most 32 columns");
  __shared__ float m_s[NS][MG];
  __shared__ float l_s[NS][MG];
  __shared__ float4 acc_s[NS][MG][HD / 4];

  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int G = H / KVH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane % LPK;                       // 16-byte column
  const bool col = LPK == C || li < C;             // the lane holds a column
  const int stream = warp * KPW + lane / LPK;
  const long long row = (long long)KVH * HD;       // elements per token slot

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

  float qv[MG][EPL];
  float m[MG], l[MG];
  float acc[MG][EPL];
  const Q* qrow = q + ((long long)b * H + (long long)kvh * G) * HD +
                  EPL * li;
#pragma unroll
  for (int g = 0; g < MG; ++g) {
#pragma unroll
    for (int i = 0; i < EPL; i += 4) {
      const float4 x = g < G && col ? load4(qrow + g * HD + i)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      qv[g][i] = x.x;
      qv[g][i + 1] = x.y;
      qv[g][i + 2] = x.z;
      qv[g][i + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const T* kc = k_pages + (long long)kvh * HD + EPL * li;  // this column
  const T* vc = v_pages + (long long)kvh * HD + EPL * li;
  const int* bt = block_table + (long long)b * max_pages;
  // the loop is uniform over the warp (its shuffles need every lane); a
  // stream past the end masks all its keys
  for (int kw = k_begin + warp * KPW * U; kw < k_end; kw += NS * U) {
    const int k0 = kw + (lane / LPK) * U;
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = k0 + u;
      if (pos < k_end && col) {
        const long long slot = (long long)bt[pos / page] * page + pos % page;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kc + slot * row));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vc + slot * row));
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
      }
    }
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g >= G) break;
      float s[U];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = qv[g][0] * elem<T>(kr[u], 0);
#pragma unroll
        for (int i = 1; i < EPL; ++i) d += qv[g][i] * elem<T>(kr[u], i);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        s[u] = k0 + u < k_end ? d * scale : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[g] - mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = k0 + u < k_end ? expf(s[u] - mx) : 0.f;
        sum += p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] += p * elem<T>(vr[u], i);
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
    }
  }

  // merge the block's streams: every lane of a stream holds the same (m, l)
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (col) {
#pragma unroll
      for (int i = 0; i < EPL; i += 4)
        acc_s[stream][g][(EPL * li + i) / 4] = make_float4(
            acc[g][i], acc[g][i + 1], acc[g][i + 2], acc[g][i + 3]);
    }
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
      store1(out + ((long long)b * H + (long long)kvh * G + g) * HD + d,
             num / fmaxf(den, 1e-30f));
    } else {
      acc_ws[(ws_row + g) * HD + d] = num;
      if (d == 0) {
        m_ws[ws_row + g] = mx;
        l_ws[ws_row + g] = den;
      }
    }
  }
}

template <typename T, typename Q, int HD, int MG>
int launch(const Q* q, const T* k_pages, const T* v_pages,
           const int* block_table, const int* seq_lens, Q* out,
           float* m_ws, float* l_ws, float* acc_ws, int B, int H, int KVH,
           int page, int max_pages, float scale, int window, int n_split,
           cudaStream_t st) {
  paged_decode_kernel<T, Q, HD, MG>
      <<<dim3(B, KVH, n_split), kThreads, 0, st>>>(
      q, k_pages, v_pages, block_table, seq_lens, out, m_ws, l_ws, acc_ws, H,
      KVH, page, max_pages, scale, window, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return repro_split::launch_split_merge(m_ws, l_ws, acc_ws, nullptr, out, B,
                                         1, H, KVH, HD, n_split, st);
}

template <typename T, typename Q, int HD>
int launch_hd(int G, const Q* q, const T* k_pages,
              const T* v_pages, const int* block_table,
              const int* seq_lens, Q* out, float* m_ws, float* l_ws,
              float* acc_ws, int B, int H, int KVH, int page, int max_pages,
              float scale, int window, int n_split, cudaStream_t st) {
#define REPRO_DECODE_LAUNCH(MG)                                              \
  return launch<T, Q, HD, MG>(q, k_pages, v_pages, block_table, seq_lens,    \
                              out, m_ws, l_ws, acc_ws, B, H, KVH, page,      \
                              max_pages, scale, window, n_split, st)
  if (G <= 1) REPRO_DECODE_LAUNCH(1);
  if (G <= 2) REPRO_DECODE_LAUNCH(2);
  if (G <= 4) REPRO_DECODE_LAUNCH(4);
  if (G <= 8) REPRO_DECODE_LAUNCH(8);
#undef REPRO_DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename Q = float>
int paged_decode(const Q* q, const T* k_pages, const T* v_pages,
                 const int* block_table, const int* seq_lens, Q* out,
                 float* m_ws, float* l_ws, float* acc_ws, int B, int H,
                 int KVH, int hd, int page, int max_pages, float scale,
                 int window, int n_split, void* stream) {
  const int G = H / KVH;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_DECODE_HD(HD)                                                  \
  return launch_hd<T, Q, HD>(G, q, k_pages, v_pages, block_table, seq_lens,  \
                             out, m_ws, l_ws, acc_ws, B, H, KVH, page,       \
                             max_pages, scale, window, n_split, st)
  switch (hd) {
    case 32: REPRO_DECODE_HD(32);
    case 64: REPRO_DECODE_HD(64);
    case 112: REPRO_DECODE_HD(112);
    case 128: REPRO_DECODE_HD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_HD
}

}  // namespace

// Returns 0 or a CUDA error code; cudaErrorInvalidValue (1) for a head dim
// other than 32, 64, 112, 128 or a group larger than 8 (the wrapper
// refuses both first).  _f32 takes float32 pages, _bf16 bfloat16 pages,
// _f16 float16 pages, all with float32 q and out; _bf16q bf16 q and out
// over bf16 pages.
extern "C" int repro_paged_decode_f32(
    const float* q, const float* k_pages, const float* v_pages,
    const int* block_table, const int* seq_lens, float* out, float* m_ws,
    float* l_ws, float* acc_ws, int B, int H, int KVH, int hd, int page,
    int max_pages, float scale, int window, int n_split, void* stream) {
  return paged_decode<float>(q, k_pages, v_pages, block_table, seq_lens, out,
                             m_ws, l_ws, acc_ws, B, H, KVH, hd, page,
                             max_pages, scale, window, n_split, stream);
}

extern "C" int repro_paged_decode_bf16(
    const float* q, const bf16* k_pages, const bf16* v_pages,
    const int* block_table, const int* seq_lens, float* out, float* m_ws,
    float* l_ws, float* acc_ws, int B, int H, int KVH, int hd, int page,
    int max_pages, float scale, int window, int n_split, void* stream) {
  return paged_decode<bf16>(q, k_pages, v_pages, block_table, seq_lens, out,
                            m_ws, l_ws, acc_ws, B, H, KVH, hd, page,
                            max_pages, scale, window, n_split, stream);
}

extern "C" int repro_paged_decode_f16(
    const float* q, const f16* k_pages, const f16* v_pages,
    const int* block_table, const int* seq_lens, float* out, float* m_ws,
    float* l_ws, float* acc_ws, int B, int H, int KVH, int hd, int page,
    int max_pages, float scale, int window, int n_split, void* stream) {
  return paged_decode<f16>(q, k_pages, v_pages, block_table, seq_lens, out,
                           m_ws, l_ws, acc_ws, B, H, KVH, hd, page,
                           max_pages, scale, window, n_split, stream);
}

extern "C" int repro_paged_decode_bf16q(
    const bf16* q, const bf16* k_pages, const bf16* v_pages,
    const int* block_table, const int* seq_lens, bf16* out, float* m_ws,
    float* l_ws, float* acc_ws, int B, int H, int KVH, int hd, int page,
    int max_pages, float scale, int window, int n_split, void* stream) {
  return paged_decode<bf16, bf16>(q, k_pages, v_pages, block_table, seq_lens,
                                  out, m_ws, l_ws, acc_ws, B, H, KVH, hd,
                                  page, max_pages, scale, window, n_split,
                                  stream);
}
