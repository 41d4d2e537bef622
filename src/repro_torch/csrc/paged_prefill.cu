// Fused chunked-prefill paged attention for Hopper (sm_90a), float32 data
// over float32, bfloat16 or float16 pages, products on the tensor cores in
// 3xTF32.
//
// Replaces: src/repro/kernels/paged_prefill.py, paged_prefill_attention
// (Pallas body _prefill_kernel).  One call per layer per prefill group
// does what the unfused path spreads over three ops:
//   1. writes the chunk's K/V rows into the lane's pool pages (row i lands
//      at position pos0[b] + i, only for i < chunk_len[b]; a lane with
//      chunk_len 0 writes nothing), in place;
//   2. runs causal (and sliding-window) flash attention for the chunk's
//      queries over the paged history plus the chunk itself.
//
// What bounds it on an H100: at long chunks (hundreds of rows over a
// history of up to a few thousand keys) operations: 4 * hd flops per
// visible (query head, key) pair on O((S + kv_len) * KVH * hd) bytes.  At
// the few-row chunks the serving replay mostly runs (one lane, an 8-row
// bucket with 2 live rows on average, over a few hundred keys) the work is
// small and the time is how many SMs the launch keeps busy.
//
// What the design does about it:
// - Tensor cores: Q·Kᵀ and P·V are mma.sync.m16n8k8 TF32 products with
//   fp32 accumulators (the helpers, shared with B4 and B6, are in
//   mma_tf32.cuh).  TF32 alone keeps about three digits, so each fp32
//   operand x is split into big = tf32(x) (cvt.rna.tf32.f32) and small =
//   tf32(x - big) and the kernel sums small·big + big·small + big·big
//   (3xTF32).  x - big is exact in fp32 and handed to the tensor core as
//   it is; the tensor core reads it as TF32 by dropping its low 13 bits
//   (truncation, no second cvt: 10% of the kernel's time at the timed
//   shape on an H100).  The error left is the dropped small·small term
//   and that truncation, below 2^-20 of each product; the fp32
//   accumulation of the sums costs more.
//   mma.sync, not wgmma: wgmma's TF32 form wants both operands K-major in
//   shared memory, so V would have to be staged transposed, and the
//   fragments of mma.sync let the softmax run on the score registers.
// - A block is one (lane, KV head, 128-row query tile, key split).  Its
//   query rows are the (position, group member) pairs of the KV head's GQA
//   group, position-major, so every staged K/V row serves the G heads that
//   share it.  Eight warps own 16 rows each (eight rather than four: 7%
//   faster at the timed shape on an H100, 32% at head dim 128).  Causal
//   query tiles are launched last first, so the blocks that walk the most
//   keys start first.
// - Key tiles of 64 (four 16-key pages) are staged in shared memory by
//   16-byte cp.async copies, double-buffered: tile t + 1 is in flight while
//   tile t is computed.  Rows are padded to hd + 4 floats: 16-byte aligned,
//   and the fragment reads of Q, K (rows g, columns t) and V (rows 2t,
//   columns g) fall on 32 different banks (hd + 4 is 4 mod 32 at hd 32,
//   64 and 128 and 20 mod 32 at zamba2's 112: the rows' offsets g (hd + 4)
//   are then 0, 20, 8, 28, 16, 4, 24, 12 mod 32, still eight distinct
//   multiples of 4, and 2t (hd + 4) is 8t mod 32).  The fp32 tiles are
//   split into big / small as fragments are read, so hd 128 still fits two
//   stages.  P·V walks its hd / 8 output n-tiles four at a time and then
//   the rest (pv_mma3: at hd 112 a tail of two).
// - The online softmax runs on the score fragments: a row's max is a
//   two-step quad shuffle, its denominator is summed per thread and
//   reduced once at the end, and no barrier is taken per key.  Its
//   exponentials are __expf (a few ulp; 8% faster than expf at the timed
//   shape on an H100).  The score fragment (C layout) feeds P·V as the A
//   operand with no data movement:
//   the 8 keys of a k-step are taken in the order 0, 2, 4, 6, 1, 3, 5, 7,
//   so the thread that holds scores (g, 2t) and (g, 2t + 1) holds exactly
//   A's (g, t) and (g, t + 4); V's fragment reads rows 2t and 2t + 1 to
//   match.
// - Key split for few rows: when the query tiles alone leave the card
//   under-filled, the wrapper also splits each tile's key range over
//   n_split blocks (host-side, without a sync); each takes a balanced
//   share of the tile's 64-key tiles on the device, writes its partial
//   (m, l, acc) (l = 0 when its share is empty), and split_merge.cuh's
//   launch merges them.  With one split the block writes the output.
// - Causal key tiles past a tile's last live query are never visited, nor
//   window tiles before its first visible key.
//
// The hazard the TPU kernel avoided by program order within a lane
// (paged_prefill.py, "Pallas guarantees program order within a lane"):
// here the blocks of one lane run in parallel, so no block ever reads a
// page position that this launch writes.  Keys at positions below pos0
// (the history) are read from the pages, which this launch never writes;
// keys of the chunk itself (positions >= pos0) are read from k_new / v_new.
// Each chunk row is written once, for its own KV head, by split 0 of the
// query tile that holds the row's first group member.  Pages written for
// different lanes are exclusive after the engine's copy-on-write barrier
// (PagedKVManager.ensure_writable).
//
// bf16 pages (page_types.cuh): K/V tiles are staged as bf16, rows padded
// to hd + 8 elements (one 16-byte chunk, as hd + 4 is in fp32), so a tile
// takes half the shared memory and the history's cp.async copies half the
// bytes.  Padding by 16 bytes keeps the fragment reads conflict-free: a row
// is hd / 2 + 4 words, 4, 20 or 28 mod 32 at head dims 128 / 64, 32 and
// 112, so the 8 rows g of a K fragment start on 8 distinct multiples of 4
// (the 4 columns t share 2 words) and the rows 2t of a V fragment on 4
// distinct multiples of 8 (the 8 columns g share 4 words).  Values are
// widened to fp32 as fragments are read; a bf16 value is exact in TF32, so
// Q·Kᵀ and P·V each skip the product with K's or V's small half (zero).
// The chunk's own rows are rounded to bf16 in registers as they are staged
// (plain loads and shared stores, not cp.async), so the chunk attends over
// exactly what it writes, as the reference reads its rows back from its
// pages; the write rounds to nearest even (__float2bfloat16_rn).
//
// float16 pages take the same layout and staging as bf16 (2-byte
// elements): an fp16 value is exact in TF32 too (page_types.cuh), and a
// write rounds to nearest even (__floats2half2_rn).
//
// Output rows at i >= chunk_len[b] (padding) are zeros.  Masked scores are
// NEG_INF = -1e30 and contribute exactly 0; the denominator is floored at
// 1e-30, as in the TPU kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "page_types.cuh"
#include "split_merge.cuh"

namespace {

using repro_page::bf16;
using repro_page::f16;
using repro_page::load4;
using repro_page::stage_rounded;
using repro_page::store4;
using repro_page::to_f32;

using repro_mma::cp_async16;
using repro_mma::cp_async_commit;
using repro_mma::cp_async_wait_1;
using repro_mma::cp_async_wait_all;
using repro_mma::mma3;
using repro_mma::pv_mma3;
using repro_mma::split;
using repro_split::kNegInf;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows per block
constexpr int kBN = 64;           // keys per tile

template <typename T, int HD>  // page element type, head dim
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const float* __restrict__ q,        // (B, S, H, hd)
    const float* __restrict__ k_new,    // (B, S, KVH, hd)
    const float* __restrict__ v_new,
    T* __restrict__ k_pages,            // (n_pages, page, KVH, hd)
    T* __restrict__ v_pages,
    const int* __restrict__ block_table,  // (B, max_pages)
    const int* __restrict__ pos0_arr,     // (B,)
    const int* __restrict__ clen_arr,     // (B,)
    float* __restrict__ out,              // (B, S, H, hd)      one split
    float* __restrict__ m_ws,             // (B, KVH, n_split, S * G)
    float* __restrict__ l_ws,
    float* __restrict__ acc_ws,           // (B, KVH, n_split, S * G, hd)
    int S, int H, int KVH, int page, int max_pages, float scale, int window,
    int n_split) {
  constexpr int QST = HD + 4;   // shared query row stride in floats
  constexpr int EC = repro_page::kPerChunk<T>;  // elements per 16 bytes
  constexpr int ST = HD + EC;   // shared K/V row stride in elements of T
  constexpr int C4 = HD / 4;    // fp32 16-byte chunks of a query row
  constexpr int CK = HD / EC;   // 16-byte chunks of a staged K/V row
  constexpr int NK = HD / 8;    // k-steps of Q·Kᵀ, n-tiles of P·V
  constexpr int NJ = kBN / 8;   // n-tiles of Q·Kᵀ, k-steps of P·V
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // kBM x QST
  T* k_s = reinterpret_cast<T*>(q_s + kBM * QST);  // 2 x kBN x ST
  T* v_s = k_s + 2 * kBN * ST;                     // 2 x kBN x ST

  const int b = blockIdx.x, kvh = blockIdx.y;
  // the last query tiles see the most keys: they are launched first
  const int n_qt = gridDim.z / n_split;
  const int qt = n_qt - 1 - (int)blockIdx.z / n_split;
  const int split_id = blockIdx.z % n_split;
  const int G = H / KVH;
  const int R = S * G;                     // rows of the (lane, KV head)
  const int r0 = qt * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int pos0 = pos0_arr[b], n_tok = clen_arr[b];
  const long long row = (long long)KVH * HD;       // floats per token slot
  const int r_end = min(r0 + kBM, R);
  const int live_end = min(r_end, n_tok * G);      // live rows: [r0, live_end)
  const bool direct = n_split == 1;

  // ---- 1. chunk rows into the pages: split 0 of the row's tile ----
  if (split_id == 0) {
    const int i_lo = (r0 + G - 1) / G;
    const int i_hi = min((r0 + kBM + G - 1) / G, n_tok);
    for (int e = tid; e < (i_hi - i_lo) * C4; e += kThreads) {
      const int i = i_lo + e / C4, c = e % C4;
      const int pos = pos0 + i;
      if (pos / page >= max_pages) continue;
      const long long pid = block_table[(long long)b * max_pages + pos / page];
      const long long dst =
          (pid * page + pos % page) * row + (long long)kvh * HD + 4 * c;
      const long long src =
          ((long long)b * S + i) * row + (long long)kvh * HD + 4 * c;
      store4(k_pages + dst, load4(k_new + src));
      store4(v_pages + dst, load4(v_new + src));
    }
  }

  // ---- padded rows of this tile are zeros (the merge writes them when
  //      the keys are split) ----
  if (direct) {
    for (int e = tid; e < (r_end - max(live_end, r0)) * HD; e += kThreads) {
      const int r = max(live_end, r0) + e / HD, d = e % HD;
      out[(((long long)b * S + r / G) * H + (long long)kvh * G + r % G) * HD + d] = 0.f;
    }
  }
  if (live_end <= r0) return;

  // ---- the key range of the tile's live rows, and this split's share ----
  const int q_first = pos0 + r0 / G;
  const int q_last = pos0 + (live_end - 1) / G;
  const int k_lo = window > 0 ? max(q_first - window + 1, 0) : 0;
  const int k_hi = q_last + 1;
  const int n_tiles = (k_hi - k_lo + kBN - 1) / kBN;
  const int t_lo = (int)((long long)split_id * n_tiles / n_split);
  const int t_hi = (int)((long long)(split_id + 1) * n_tiles / n_split);

  // a tile's kBN key rows: kTPK threads per row, each issuing the row's
  // 16-byte chunks ld_c, ld_c + kTPK, ... after one block-table lookup
  // (CK need not be a multiple of kTPK: 16-bit rows at hd 112 have 14)
  constexpr int kTPK = kThreads / kBN;  // threads per key row
  constexpr int kCPT = (CK + kTPK - 1) / kTPK;  // chunks per thread, at most
  static_assert(kTPK * kBN == kThreads, "tile split");
  const int ld_p = tid / kTPK;
  const int ld_c = tid % kTPK;
  auto load_tile = [&](int t, int buf) {
    const int pos = k_lo + t * kBN + ld_p;
    T* kd = k_s + buf * kBN * ST + ld_p * ST;
    T* vd = v_s + buf * kBN * ST + ld_p * ST;
    const T* ks = k_pages;
    const T* vs = v_pages;
    bool pred = false;
    if (pos < pos0) {              // history: pages this launch never writes
      const int slot = pos / page;
      if (slot < max_pages) {
        const long long pid = block_table[(long long)b * max_pages + slot];
        const long long off = (pid * page + (pos - slot * page)) * row +
                              (long long)kvh * HD;
        ks = k_pages + off;
        vs = v_pages + off;
        pred = true;
      }
    } else if (pos < k_hi) {       // the chunk itself: from k_new / v_new
      const long long off = ((long long)b * S + (pos - pos0)) * row +
                            (long long)kvh * HD;
      if constexpr (repro_page::kSmallHalf<T>) {   // fp32: copied as it is
        ks = reinterpret_cast<const T*>(k_new + off);
        vs = reinterpret_cast<const T*>(v_new + off);
        pred = true;
      } else {                     // 16-bit: rounded in registers, staged
#pragma unroll
        for (int j = 0; j < kCPT; ++j) {
          const int c = ld_c + kTPK * j;
          if (c < CK) {
            stage_rounded(kd + EC * c, k_new + off + EC * c);
            stage_rounded(vd + EC * c, v_new + off + EC * c);
          }
        }
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const int c = ld_c + kTPK * j;
      if (c < CK) {
        cp_async16(kd + EC * c, ks + (pred ? EC * c : 0), pred);
        cp_async16(vd + EC * c, vs + (pred ? EC * c : 0), pred);
      }
    }
  };

  // query rows, zeros past the live rows; with the first key tile
  for (int e = tid; e < kBM * C4; e += kThreads) {
    const int rr = e / C4, c = e % C4;
    const int r = r0 + rr;
    const float* src = q;
    if (r < live_end)
      src = q + (((long long)b * S + r / G) * H + (long long)kvh * G + r % G) * HD + 4 * c;
    cp_async16(q_s + rr * QST + 4 * c, src, r < live_end);
  }
  if (t_lo < t_hi) load_tile(t_lo, 0);
  cp_async_commit();

  // this thread's two rows: wr + gq and wr + gq + 8 of the tile
  const int wr = warp * 16;
  const bool warp_live = r0 + wr < live_end;
  const int qpos0 = pos0 + (r0 + wr + gq) / G;
  const int qpos1 = pos0 + (r0 + wr + gq + 8) / G;
  float o[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t + 1 < t_hi) load_tile(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();               // tile t (and the queries) landed
    __syncthreads();
    if (warp_live) {
      const T* kt = k_s + buf * kBN * ST;
      const T* vt = v_s + buf * kBN * ST;
      const float* qw = q_s + wr * QST;
      // S = Q Kᵀ over this tile: 16 rows x kBN keys, NJ n-tiles of 8 keys
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t ab[4], as[4];
        split(qw[gq * QST + 8 * kk + tq], ab[0], as[0]);
        split(qw[(gq + 8) * QST + 8 * kk + tq], ab[1], as[1]);
        split(qw[gq * QST + 8 * kk + tq + 4], ab[2], as[2]);
        split(qw[(gq + 8) * QST + 8 * kk + tq + 4], ab[3], as[3]);
        float kb2[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const T* kr = kt + (8 * j + gq) * ST + 8 * kk + tq;
          kb2[j][0] = to_f32(kr[0]);
          kb2[j][1] = to_f32(kr[4]);
        }
        mma3<NJ, repro_page::kSmallHalf<T>>(s, ab, as, kb2);
      }
      // mask, scale, online softmax on the fragments
      const int kb = k_lo + t * kBN;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kb + 8 * j + 2 * tq + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          const bool valid =
              kpos <= qpos && (window <= 0 || kpos > qpos - window);
          s[j][e] = valid ? s[j][e] * scale : kNegInf;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float al0 = __expf(m0 - mx0), al1 = __expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p0 = s[j][0] > 0.5f * kNegInf ? __expf(s[j][0] - mx0) : 0.f;
        const float p1 = s[j][1] > 0.5f * kNegInf ? __expf(s[j][1] - mx0) : 0.f;
        const float p2 = s[j][2] > 0.5f * kNegInf ? __expf(s[j][2] - mx1) : 0.f;
        const float p3 = s[j][3] > 0.5f * kNegInf ? __expf(s[j][3] - mx1) : 0.f;
        l0 += p0 + p1;
        l1 += p2 + p3;
        // A fragment of P over keys 8j + (0, 2, 4, 6, 1, 3, 5, 7)
        uint32_t ab[4], as[4];
        split(p0, ab[0], as[0]);
        split(p2, ab[1], as[1]);
        split(p1, ab[2], as[2]);
        split(p3, ab[3], as[3]);
        const T* v0 = vt + (8 * j + 2 * tq) * ST + gq;
        pv_mma3<NK>(o, ab, as, v0, ST);
      }
    }
    __syncthreads();                 // buffer buf free for tile t + 2
  }
  cp_async_wait_all();               // an empty share still staged the queries

  if (!warp_live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + wr + gq + 8 * half;
    if (r >= live_end) continue;
    const float l = half ? l1 : l0;
    if (direct) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      float* orow = out + (((long long)b * S + r / G) * H + (long long)kvh * G + r % G) * HD;
#pragma unroll
      for (int n = 0; n < NK; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * tq) =
            make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    } else {
      const long long w = (((long long)b * KVH + kvh) * n_split + split_id) * R + r;
      if (tq == 0) {
        m_ws[w] = half ? m1 : m0;
        l_ws[w] = l;
      }
      float* arow = acc_ws + w * HD;
#pragma unroll
      for (int n = 0; n < NK; ++n)
        *reinterpret_cast<float2*>(arow + 8 * n + 2 * tq) =
            make_float2(o[n][2 * half], o[n][2 * half + 1]);
    }
  }
}

template <typename T, int HD>
int launch(const float* q, const float* k_new, const float* v_new,
           T* k_pages, T* v_pages, const int* block_table,
           const int* pos0, const int* chunk_len, float* out, float* m_ws,
           float* l_ws, float* acc_ws, int B, int S, int H, int KVH, int page,
           int max_pages, float scale, int window, int n_split,
           cudaStream_t st) {
  constexpr size_t smem =
      sizeof(float) * (size_t)kBM * (HD + 4) +
      sizeof(T) * (size_t)4 * kBN * (HD + repro_page::kPerChunk<T>);
  static bool attr_set = false;
  if (smem > 48 * 1024 && !attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int n_qt = (S * (H / KVH) + kBM - 1) / kBM;
  paged_prefill_kernel<T, HD>
      <<<dim3(B, KVH, n_qt * n_split), kThreads, smem, st>>>(
      q, k_new, v_new, k_pages, v_pages, block_table, pos0, chunk_len, out,
      m_ws, l_ws, acc_ws, S, H, KVH, page, max_pages, scale, window, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return repro_split::launch_split_merge(m_ws, l_ws, acc_ws, chunk_len, out, B,
                                         S, H, KVH, HD, n_split, st);
}

template <typename T>
int paged_prefill(const float* q, const float* k_new, const float* v_new,
                  T* k_pages, T* v_pages, const int* block_table,
                  const int* pos0, const int* chunk_len, float* out,
                  float* m_ws, float* l_ws, float* acc_ws, int B, int S,
                  int H, int KVH, int hd, int page, int max_pages,
                  float scale, int window, int n_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_PREFILL_HD(HD)                                                 \
  return launch<T, HD>(q, k_new, v_new, k_pages, v_pages, block_table, pos0, \
                       chunk_len, out, m_ws, l_ws, acc_ws, B, S, H, KVH,     \
                       page, max_pages, scale, window, n_split, st)
  switch (hd) {
    case 32: REPRO_PREFILL_HD(32);
    case 64: REPRO_PREFILL_HD(64);
    case 112: REPRO_PREFILL_HD(112);
    case 128: REPRO_PREFILL_HD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_PREFILL_HD
}

}  // namespace

// Returns 0 or a CUDA error code; cudaErrorInvalidValue (1) for a head dim
// other than 32, 64, 112 or 128 (the wrapper refuses it first).  _f32
// takes float32 pages, _bf16 bfloat16 pages, _f16 float16 pages.
extern "C" int repro_paged_prefill_f32(
    const float* q, const float* k_new, const float* v_new, float* k_pages,
    float* v_pages, const int* block_table, const int* pos0,
    const int* chunk_len, float* out, float* m_ws, float* l_ws,
    float* acc_ws, int B, int S, int H, int KVH, int hd, int page,
    int max_pages, float scale, int window, int n_split, void* stream) {
  return paged_prefill<float>(q, k_new, v_new, k_pages, v_pages, block_table,
                              pos0, chunk_len, out, m_ws, l_ws, acc_ws, B, S,
                              H, KVH, hd, page, max_pages, scale, window,
                              n_split, stream);
}

extern "C" int repro_paged_prefill_bf16(
    const float* q, const float* k_new, const float* v_new, bf16* k_pages,
    bf16* v_pages, const int* block_table, const int* pos0,
    const int* chunk_len, float* out, float* m_ws, float* l_ws,
    float* acc_ws, int B, int S, int H, int KVH, int hd, int page,
    int max_pages, float scale, int window, int n_split, void* stream) {
  return paged_prefill<bf16>(q, k_new, v_new, k_pages, v_pages, block_table,
                             pos0, chunk_len, out, m_ws, l_ws, acc_ws, B, S,
                             H, KVH, hd, page, max_pages, scale, window,
                             n_split, stream);
}

extern "C" int repro_paged_prefill_f16(
    const float* q, const float* k_new, const float* v_new, f16* k_pages,
    f16* v_pages, const int* block_table, const int* pos0,
    const int* chunk_len, float* out, float* m_ws, float* l_ws,
    float* acc_ws, int B, int S, int H, int KVH, int hd, int page,
    int max_pages, float scale, int window, int n_split, void* stream) {
  return paged_prefill<f16>(q, k_new, v_new, k_pages, v_pages, block_table,
                            pos0, chunk_len, out, m_ws, l_ws, acc_ws, B, S,
                            H, KVH, hd, page, max_pages, scale, window,
                            n_split, stream);
}
