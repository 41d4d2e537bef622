// Fused speculative-verify paged attention for Hopper (sm_90a), float32
// data over float32, bfloat16 or float16 pages.
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
// 3.35 TB/s: about 1.3 us for qwen3-1.7b (8 KV heads, hd 128) at 524 keys.
//
// What the design does about it: the shape is a few live rows (chunk_len
// x G, 4 on the spec replay) over a long history, so the keys are spread
// over warps and blocks and each key row is read once.
//  * Grid (lane, KV head, split); 4 warps a block, two blocks an SM, and
//    as many splits as one wave of blocks holds (the wrapper's n_splits),
//    so the history's bytes are spread over every SM.  A split takes a
//    balanced share of its lane's history pages; its keys are cut into
//    16-key tiles aligned to 16 positions (one page at page 16: one
//    block-table read per tile) and each warp takes its own tiles.  The
//    designated split (the last) also takes the window's own keys, in
//    tiles of 16, straight from k_new / v_new.
//  * Head dim over lanes: each lane holds a float4 of every live query row
//    in registers (hd up to 128, any multiple of 4; lanes past hd / 4
//    idle), loads the same float4 of each key row (512 coalesced bytes a
//    row at hd 128), and a row's 16 scores of a tile are one transposing
//    warp-shuffle reduction (16 shuffles, transpose_sum16).  Each
//    warp keeps its own online softmax (m, l, acc) per row; the rows are
//    taken 4 at a time (one pass at the replay's 4), and a tile's 16 K and
//    V rows are loaded at once, with no condition between a load and the
//    next (a predicated load followed by a select made each wait for the
//    one before: 9 us a tile on an H100), so one memory latency serves
//    the tile.
//  * The block's warps merge their partials through shared memory (4
//    warps x 4 rows, sized for the rows of a pass, not S x G) and write
//    the block's partial to scratch.
//  * One launch: the last block to finish for a (lane, KV head) merges
//    that pair's splits.  Each block makes its partial visible
//    (__threadfence) and takes an atomicAdd ticket on the pair's counter;
//    the block that draws n_split - 1 reads every split's partial through
//    L2 (a warp per row, its lanes over the splits) and adds them in split
//    order, so the output's bits do not depend on which block finished
//    last, and resets the counter to 0 for the next launch.  The
//    merge's arithmetic is split_merge.cuh's (split_weight,
//    inv_denominator).  A block whose share is empty carries l = 0 and
//    the merge skips it.
//
// The hazard the TPU kernel avoided by program order within a lane: here
// the splits of one lane run in parallel.  History keys (positions below
// pos0) are read from the pages, which this launch never writes; the
// window's own keys are read straight from k_new / v_new by the designated
// split, which also writes them into the pages.  So no block reads a page
// position that this launch writes.  Pages written for a lane are
// exclusive to it after the engine's copy-on-write barrier.
//
// bf16 pages (page_types.cuh): a lane loads its four elements of a
// history key row as 8 bytes and widens them to fp32 in registers; the
// window's own rows are read from k_new / v_new and rounded to bf16 in
// registers, so the window attends over exactly what it writes (rounded
// to nearest even), as the reference reads them back from its pages.
// Which of the two a tile reads is the same for all of a warp's lanes.
// float16 pages are read, widened and rounded the same way.
//
// Semantics kept from the TPU kernel: masked scores are NEG_INF = -1e30,
// the softmax denominator is floored at 1e-30, accumulation is float32.
// Masked keys contribute exactly 0 (explicitly, not through exp of -1e30):
// a key outside the split's range is never read from its own row.
#include <cuda_runtime.h>

#include "page_types.cuh"
#include "split_merge.cuh"

namespace {

using repro_page::bf16;
using repro_page::f16;
using repro_page::load4;
using repro_page::round4;
using repro_page::store4;

using repro_split::inv_denominator;
using repro_split::kNegInf;
using repro_split::split_weight;
using repro_split::warp_max;
using repro_split::warp_sum;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTK = 16;                  // keys per warp tile
constexpr int kRB = 4;                   // query rows a pass holds
constexpr int kMaxHd = 128;              // a float4 per lane

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// v[k]: this lane's part of key k's score (its 4 dims), k < 16.  Sums every
// key over the warp's 32 lanes in 16 shuffles (5 rounds, each halving the
// keys a lane keeps: 8 + 4 + 2 + 1 + 1), not 16 reductions of 5; lanes 2k
// and 2k + 1 end with key k's sum.
__device__ __forceinline__ float transpose_sum16(const float (&v)[kTK],
                                                 int lane) {
  float a[8], b[4], c[2];
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4, h1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = (h4 ? v[i + 8] : v[i]) +
           __shfl_xor_sync(0xffffffffu, h4 ? v[i] : v[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (h3 ? a[i + 4] : a[i]) +
           __shfl_xor_sync(0xffffffffu, h3 ? a[i] : a[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (h2 ? b[i + 2] : b[i]) +
           __shfl_xor_sync(0xffffffffu, h2 ? b[i] : b[i + 2], 4);
  float d = (h1 ? c[1] : c[0]) +
            __shfl_xor_sync(0xffffffffu, h1 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(0xffffffffu, d, 1);
}

template <typename T>  // page element type
__global__ void __launch_bounds__(kThreads, 1) paged_verify_kernel(
    const float* __restrict__ q,        // (B, S, H, hd)
    const float* __restrict__ k_new,    // (B, S, KVH, hd)
    const float* __restrict__ v_new,
    T* __restrict__ k_pages,            // (n_pages, page, KVH, hd)
    T* __restrict__ v_pages,
    const int* __restrict__ block_table,  // (B, max_pages)
    const int* __restrict__ pos0_arr,     // (B,)
    const int* __restrict__ clen_arr,     // (B,)
    float* __restrict__ m_ws,             // (B, KVH, n_split, S * G)
    float* __restrict__ l_ws,             // (B, KVH, n_split, S * G)
    float* __restrict__ acc_ws,           // (B, KVH, n_split, S * G, hd)
    int* __restrict__ counters,           // (B * KVH,), zero between launches
    float* __restrict__ out,              // (B, S, H, hd)
    int S, int H, int KVH, int hd, int page, int max_pages, float scale,
    int window, int n_split) {
  __shared__ float m_s[kWarps][kRB];
  __shared__ float l_s[kWarps][kRB];
  __shared__ __align__(16) float a_s[kWarps][kRB][kMaxHd];
  __shared__ int ticket;

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int G = H / KVH;
  const int R = S * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n4 = hd >> 2;                // float4s per row
  const bool has_dims = lane < n4;
  const int pos0 = pos0_arr[b];
  const int n_tok = clen_arr[b];
  const long long row = (long long)KVH * hd;  // elements per token slot

  if (n_tok <= 0) {                      // masked lane: no write, zero rows
    if (split == 0)
      for (int e = tid; e < S * G * n4; e += kThreads) {
        const int r = e / n4, d4 = e % n4;
        const long long o =
            (((long long)b * S + r / G) * H + (long long)kvh * G + r % G) * hd;
        reinterpret_cast<float4*>(out + o)[d4] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    return;
  }
  const bool own = split == n_split - 1; // designated split

  // ---- the window's rows into the pages (designated split, own head) ----
  if (own) {
    for (int e = tid; e < n_tok * n4; e += kThreads) {
      const int i = e / n4, d4 = e % n4;
      const int pos = pos0 + i;
      const int slot = pos / page;
      if (slot >= max_pages) continue;
      const long long pid = block_table[(long long)b * max_pages + slot];
      const long long dst =
          (pid * page + pos % page) * row + (long long)kvh * hd + 4 * d4;
      const long long src =
          ((long long)b * S + i) * row + (long long)kvh * hd + 4 * d4;
      store4(k_pages + dst, load4(k_new + src));
      store4(v_pages + dst, load4(v_new + src));
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
  const int k_end = max(min(pos0, my_hi * page), k_begin);
  const int t_lo = k_begin & ~(kTK - 1);         // 16-aligned first tile
  const int n_htiles = k_end > k_begin ? (k_end - t_lo + kTK - 1) / kTK : 0;
  const int n_tiles = n_htiles + (own ? (n_tok + kTK - 1) / kTK : 0);
  const int R_live = n_tok * G;          // live rows, position-major
  const long long ws_base = (((long long)b * KVH + kvh) * n_split + split)
                            * (long long)R;

  for (int r0 = 0; r0 < R_live; r0 += kRB) {
    const int nr = min(kRB, R_live - r0);
    float4 qv[kRB], acc[kRB];
    float m[kRB], l[kRB], sc[kRB], pr[kRB];
    int qpos[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      const int rr = r0 + min(r, nr - 1);
      const int i = rr / G;
      qpos[r] = pos0 + i;
      qv[r] = has_dims ? reinterpret_cast<const float4*>(
                             q + (((long long)b * S + i) * H +
                                  (long long)kvh * G + rr % G) * hd)[lane]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      m[r] = kNegInf;
      l[r] = 0.f;
    }

    for (int tile = warp; tile < n_tiles; tile += kWarps) {
      // key j = lane / 2 of the tile: its position, whether it is in this
      // split's range, and the row it is read from: a key out of range
      // reads the nearest row in range (written, finite data) and weighs 0,
      // so that no load waits on a condition
      const bool hist = tile < n_htiles;
      const int j = lane >> 1;
      int kpos;
      bool in_range;
      long long off;
      if (hist) {
        kpos = t_lo + kTK * tile + j;
        in_range = kpos >= k_begin && kpos < k_end;
        const int kp = min(max(kpos, k_begin), k_end - 1);
        off = ((long long)block_table[(long long)b * max_pages + kp / page]
                   * page + kp % page) * row + (long long)kvh * hd;
      } else {
        const int jj = kTK * (tile - n_htiles) + j;
        kpos = pos0 + jj;
        in_range = jj < n_tok;
        off = ((long long)b * S + min(jj, n_tok - 1)) * row +
              (long long)kvh * hd;
      }
      const int d0 = 4 * min(lane, n4 - 1);
      // every K and V row of the tile in flight at once (lanes past hd / 4
      // reread the last four dims and hold q = 0); hist is the same for
      // the whole warp
      float4 kv[kTK], vv[kTK];
      if (hist) {
#pragma unroll
        for (int kk = 0; kk < kTK; ++kk) {
          const long long o = __shfl_sync(0xffffffffu, off, 2 * kk) + d0;
          kv[kk] = load4(k_pages + o);
          vv[kk] = load4(v_pages + o);
        }
      } else {                           // the window's rows, as written
#pragma unroll
        for (int kk = 0; kk < kTK; ++kk) {
          const long long o = __shfl_sync(0xffffffffu, off, 2 * kk) + d0;
          kv[kk] = round4<T>(load4(k_new + o));
          vv[kk] = round4<T>(load4(v_new + o));
        }
      }

      // Every row slot runs, live or not (a slot past nr repeats the last
      // live row and is never written out): no shuffle sits under a
      // condition the compiler cannot prove uniform, which made it take
      // its divergent-warp path, 4 us a tile on an H100.
      // scores: lanes 2k and 2k + 1 hold key k's
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        float v[kTK];
#pragma unroll
        for (int kk = 0; kk < kTK; ++kk) v[kk] = dot4(qv[r], kv[kk]);
        sc[r] = transpose_sum16(v, lane) * scale;
      }
      // online softmax, each row over the tile's 16 keys (each twice)
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const bool valid = in_range && kpos <= qpos[r] &&
                           (window <= 0 || kpos > qpos[r] - window);
        const float m_new = fmaxf(m[r], warp_max(valid ? sc[r] : kNegInf));
        const float p = valid ? expf(sc[r] - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum((lane & 1) ? 0.f : p);
        m[r] = m_new;
        acc[r].x *= alpha;
        acc[r].y *= alpha;
        acc[r].z *= alpha;
        acc[r].w *= alpha;
        pr[r] = p;
      }
      // acc += p . V
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
#pragma unroll
        for (int r = 0; r < kRB; ++r) {
          const float p = __shfl_sync(0xffffffffu, pr[r], 2 * kk);
          acc[r].x += p * vv[kk].x;
          acc[r].y += p * vv[kk].y;
          acc[r].z += p * vv[kk].z;
          acc[r].w += p * vv[kk].w;
        }
      }
    }

    // ---- the block's partial: its warps merged in warp order ----
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      if (r < nr) {
        if (lane == 0) {
          m_s[warp][r] = m[r];
          l_s[warp][r] = l[r];
        }
        if (has_dims)
          reinterpret_cast<float4*>(a_s[warp][r])[lane] = acc[r];
      }
    }
    __syncthreads();
    for (int e = tid; e < nr * n4; e += kThreads) {
      const int r = e / n4, d4 = e % n4;
      float mx = kNegInf;
      for (int w = 0; w < kWarps; ++w)
        if (l_s[w][r] > 0.f) mx = fmaxf(mx, m_s[w][r]);
      float den = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < kWarps; ++w) {
        const float c = split_weight(m_s[w][r], l_s[w][r], mx);
        const float4 v = reinterpret_cast<const float4*>(a_s[w][r])[d4];
        den += l_s[w][r] * c;
        a.x += v.x * c;
        a.y += v.y * c;
        a.z += v.z * c;
        a.w += v.w * c;
      }
      const long long w = ws_base + r0 + r;
      reinterpret_cast<float4*>(acc_ws + w * hd)[d4] = a;
      if (d4 == 0) {
        m_ws[w] = mx;
        l_ws[w] = den;
      }
    }
    __syncthreads();                     // m_s, l_s, a_s reused next pass
  }

  // ---- the last block of the (lane, KV head) merges its splits ----
  __threadfence();                       // this block's partial, visible
  __syncthreads();
  int* counter = counters + (long long)b * KVH + kvh;
  if (tid == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (ticket != n_split - 1) return;
  __threadfence();
  const long long base = ((long long)b * KVH + kvh) * n_split * (long long)R;
  for (int e = R_live * n4 + tid; e < R * n4; e += kThreads) {  // padded rows
    const int r = e / n4, d4 = e % n4;
    reinterpret_cast<float4*>(out + (((long long)b * S + r / G) * H +
                                     (long long)kvh * G + r % G) * hd)[d4] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // one warp per live row: its lanes read the splits' (m, l) at once, then
  // the row's accumulators are added in split order.  Every split wrote
  // its rows (zeros where its share was empty), so the loads need no
  // condition and the weights decide.
  const int d4 = min(lane, n4 - 1);
  for (int r = warp; r < R_live; r += kWarps) {
    const long long w0 = base + r;
    float ls = 0.f, ms = kNegInf;        // split `lane` of the first 32
    if (lane < n_split) {
      ls = __ldcg(l_ws + w0 + (long long)lane * R);
      ms = __ldcg(m_ws + w0 + (long long)lane * R);
    }
    float mx = ls > 0.f ? ms : kNegInf;
    for (int s = lane + 32; s < n_split; s += 32) {
      const long long w = w0 + (long long)s * R;
      if (__ldcg(l_ws + w) > 0.f) mx = fmaxf(mx, __ldcg(m_ws + w));
    }
    mx = warp_max(mx);
    float den = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_split; s0 += 32) {
      if (s0 > 0) {
        ls = 0.f;
        ms = kNegInf;
        if (s0 + lane < n_split) {
          ls = __ldcg(l_ws + w0 + (long long)(s0 + lane) * R);
          ms = __ldcg(m_ws + w0 + (long long)(s0 + lane) * R);
        }
      }
      const float c = split_weight(ms, ls, mx);
      den += ls * c;
      const int cnt = min(32, n_split - s0);
#pragma unroll 8
      for (int k = 0; k < cnt; ++k) {
        const float ck = __shfl_sync(0xffffffffu, c, k);
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            acc_ws + (w0 + (long long)(s0 + k) * R) * hd) + d4);
        a.x += v.x * ck;
        a.y += v.y * ck;
        a.z += v.z * ck;
        a.w += v.w * ck;
      }
    }
    const float inv = inv_denominator(warp_sum(den));
    const int i = r / G;
    if (has_dims)
      reinterpret_cast<float4*>(out + (((long long)b * S + i) * H +
                                       (long long)kvh * G + r % G) * hd)[lane] =
          make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
  if (tid == 0) *counter = 0;            // ready for the next launch
}

template <typename T>
int paged_verify(const float* q, const float* k_new, const float* v_new,
                 T* k_pages, T* v_pages, const int* block_table,
                 const int* pos0, const int* chunk_len, float* m_ws,
                 float* l_ws, float* acc_ws, int* counters, float* out, int B,
                 int S, int H, int KVH, int hd, int page, int max_pages,
                 float scale, int window, int n_split, void* stream) {
  if (hd % 4 != 0 || hd > kMaxHd || hd <= 0 || B > 65535 || KVH > 65535 ||
      n_split < 1 || n_split > 65535 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  paged_verify_kernel<T><<<dim3(B, KVH, n_split), kThreads, 0,
                           (cudaStream_t)stream>>>(
      q, k_new, v_new, k_pages, v_pages, block_table, pos0, chunk_len, m_ws,
      l_ws, acc_ws, counters, out, S, H, KVH, hd, page, max_pages, scale,
      window, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// counters: B * KVH int32, zero before the launch, zero again after it
// (the wrapper allocates them zeroed once per device).  m_ws / l_ws
// (B, KVH, n_split, S * G) and acc_ws (B, KVH, n_split, S * G, hd): the
// splits' partials.  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for a head dim that is no multiple of 4 or above
// 128, or a grid the card cannot launch.  _f32 takes float32 pages, _bf16
// bfloat16 pages, _f16 float16 pages.
extern "C" int repro_paged_verify_f32(
    const float* q, const float* k_new, const float* v_new, float* k_pages,
    float* v_pages, const int* block_table, const int* pos0,
    const int* chunk_len, float* m_ws, float* l_ws, float* acc_ws,
    int* counters, float* out, int B, int S, int H, int KVH, int hd,
    int page, int max_pages, float scale, int window, int n_split,
    void* stream) {
  return paged_verify<float>(q, k_new, v_new, k_pages, v_pages, block_table,
                             pos0, chunk_len, m_ws, l_ws, acc_ws, counters,
                             out, B, S, H, KVH, hd, page, max_pages, scale,
                             window, n_split, stream);
}

extern "C" int repro_paged_verify_bf16(
    const float* q, const float* k_new, const float* v_new, bf16* k_pages,
    bf16* v_pages, const int* block_table, const int* pos0,
    const int* chunk_len, float* m_ws, float* l_ws, float* acc_ws,
    int* counters, float* out, int B, int S, int H, int KVH, int hd,
    int page, int max_pages, float scale, int window, int n_split,
    void* stream) {
  return paged_verify<bf16>(q, k_new, v_new, k_pages, v_pages, block_table,
                            pos0, chunk_len, m_ws, l_ws, acc_ws, counters,
                            out, B, S, H, KVH, hd, page, max_pages, scale,
                            window, n_split, stream);
}

extern "C" int repro_paged_verify_f16(
    const float* q, const float* k_new, const float* v_new, f16* k_pages,
    f16* v_pages, const int* block_table, const int* pos0,
    const int* chunk_len, float* m_ws, float* l_ws, float* acc_ws,
    int* counters, float* out, int B, int S, int H, int KVH, int hd,
    int page, int max_pages, float scale, int window, int n_split,
    void* stream) {
  return paged_verify<f16>(q, k_new, v_new, k_pages, v_pages, block_table,
                           pos0, chunk_len, m_ws, l_ws, acc_ws, counters,
                           out, B, S, H, KVH, hd, page, max_pages, scale,
                           window, n_split, stream);
}
