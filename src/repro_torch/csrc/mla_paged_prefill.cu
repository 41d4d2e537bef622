// Fused MLA latent-page chunked prefill for Hopper (sm_90a), float32 data
// over float32, bfloat16 or float16 latent pages, products on the tensor
// cores in 3xTF32.
//
// Replaces: src/repro/kernels/paged_prefill.py, mla_paged_prefill_attention
// (Pallas body _mla_prefill_kernel).  One launch per MLA layer per prefill
// group does what the unfused path spreads over three ops:
//   phase 1  writes the chunk's headless latent rows (ckv, r floats, and
//            krope, rope floats, one of each per token, shared by every
//            head) into the lane's pool pages: row i lands at position
//            pos0[b] + i, only for i < chunk_len[b]; a lane with chunk_len 0
//            writes nothing;
//   phase 2  runs causal flash attention of all S * H query rows of the
//            lane against that one latent stream: logits
//            (q_lat . ckv + q_rope . krope) * scale, the context accumulated
//            in latent space (the caller up-projects through w_uv and wo).
//
// What bounds it on an H100: every (query row, visible key) pair costs
// 2 * (r + rope) + 2 * r = 2176 flops at deepseek-v2's widths (r 512,
// rope 64), while each key is 2304 bytes shared by all 128 heads and every
// query position of the chunk: a GEMM-shaped problem (M = S * H rows,
// K = 576, N = 512) far above the float32 ridge, bound by operations.
//
// What the design does about it:
//  * Tensor cores: both products are mma.sync.m16n8k8 TF32 in 3xTF32
//    (helpers in mma_tf32.cuh, as in B2), and one staged key tile serves
//    both, since the value is the key's first r columns (ckv): logits
//    rows x 576 against keys x 576, context P against keys x 512.
//  * Rows are folded position-major (row i * H + h is position i, head h),
//    so the rows of a block share a causal limit when H is a multiple of
//    the block's 32 rows (deepseek's 128 heads: 4 blocks per position).
//  * A block is 8 warps: 2 row groups of 16 rows x 4 warps.  A row's
//    accumulator is 512 floats, so the 4 warps of a row group split the
//    512 output columns, 128 each (64 accumulator floats a lane).  The
//    logits of a row group's 16 rows x 32 keys are formed once, shared out
//    as 2 key halves x 2 depth halves (288 columns) over the same 4 warps,
//    and handed over through shared memory: every warp sums the two depth
//    halves in the same order and runs the same online softmax on the
//    whole 16 x 32 tile, so the 4 copies of a row's (m, l) agree exactly.
//  * Key tiles of 32 keys x 576 floats (74 KB) are staged by 16-byte
//    cp.async, double-buffered; with the 32 query rows that is 226 KB of
//    the 227 KB a block can have, so one block per SM.  Rows are padded
//    to 580 floats so that the fragment reads fall on 32 banks.
//  * Key split for few rows: when the row tiles give under one block per
//    SM (the replay's one-lane 16-row bucket: 64 blocks), the wrapper also
//    splits each tile's key range over n_split blocks; each takes a
//    balanced share of the tile's 32-key tiles, writes its partial
//    (m, l, acc) (l = 0 and acc zeros when its share is empty), and
//    split_merge.cuh's launch merges them (KVH 1, G = H, hd = r; it writes
//    the padded rows' zeros).  With one split the block writes the output.
//  * Causal row tiles are launched last first (they see the most keys);
//    key tiles past a tile's last live row are never visited.
//
// The hazard the TPU kernel avoided by program order within a lane: here
// the row tiles of one lane run in parallel, so no block reads a position
// that another block may be writing.  Keys below pos0 (the history) are
// read from the pages, which this launch never writes at those positions;
// keys of the chunk itself come straight from ckv_new / krope_new.  Each
// chunk row is written once, by split 0 of the row tile that holds the
// position's first row.  Pages written by different lanes are exclusive
// after the engine's copy-on-write barrier (PagedKVManager.ensure_writable);
// a masked lane (chunk_len 0) aliases another lane's table and writes
// nothing.
//
// bf16 pages (page_types.cuh): key tiles are staged as bf16, rows padded
// to 584 elements (292 words, 4 mod 32: the fragment reads stay on 32
// banks, as in B2), so the two stages take 75 KB in place of 148 and a
// block 157 KB (still one block per SM: the staging is not deepened).
// Values are widened to fp32 as fragments are read, and both products skip
// the key's small TF32 half (zero for a bf16 value).  The chunk's own
// latent rows are rounded to bf16 in registers as they are staged, so the
// chunk attends over exactly what it writes (rounded to nearest even), as
// the reference reads them back from its pages.  float16 latent pages
// take the same layout and staging (an fp16 value is exact in TF32 too).
//
// Output rows at i >= chunk_len[b] (padding, masked lanes) are zeros.
// Masked scores are NEG_INF = -1e30 and contribute an exact 0, and the
// denominator is floored at 1e-30, as in the TPU kernel.  scale is an
// argument ((qk_nope + rope)^-0.5 for deepseek-v2).
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
using repro_mma::load_a;
using repro_mma::mma3;
using repro_mma::p_fragment;
using repro_mma::quad_max;
using repro_mma::quad_sum;
using repro_split::kNegInf;

constexpr int kR = 512;                  // kv_lora_rank the kernel is built for
constexpr int kRope = 64;                // qk_rope_head_dim
constexpr int kD = kR + kRope;           // elements per staged key
constexpr int kQST = kD + 4;             // shared query row stride in floats
constexpr int kC4 = kD / 4;              // fp32 16-byte chunks of a row
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRG = 2;                   // row groups of 16 per block
constexpr int kRows = 16 * kRG;          // query rows per block
constexpr int kCW = kWarps / kRG;        // warps per row group
constexpr int kKeys = 32;                // keys per staged tile
constexpr int kNJ = kKeys / 8;           // n-tiles of a key tile
constexpr int kKS = kD / 8 / 2;          // a warp's Q·Kᵀ k-steps (depth half)
constexpr int kNO = kR / 8 / kCW;        // a warp's P·V n-tiles (128 columns)
constexpr int kTPK = kThreads / kKeys;   // loader threads per key row
constexpr int kXS = kRG * kCW * 2 * 4 * 32;  // floats of partial logits

// shared row stride of a staged key in elements of T (one 16-byte chunk of
// padding), 16-byte chunks of a staged key, and the block's shared memory
template <typename T>
constexpr int kST = kD + repro_page::kPerChunk<T>;
template <typename T>
constexpr int kCK = kD / repro_page::kPerChunk<T>;
template <typename T>
constexpr size_t kSmem = sizeof(float) * ((size_t)kRows * kQST + kXS) +
                         sizeof(T) * (size_t)2 * kKeys * kST<T>;

static_assert(kCW == 4, "2 key halves x 2 depth halves per row group");
static_assert(kCK<float> % kTPK == 0 && kCK<bf16> % kTPK == 0,
              "a key row's chunks share out evenly");
static_assert(kSmem<float> <= 232448, "one block per SM");

template <typename T>  // page element type
__global__ void __launch_bounds__(kThreads, 1) mla_prefill_kernel(
    const float* __restrict__ q_lat,      // (B, S, H, kR)
    const float* __restrict__ q_rope,     // (B, S, H, kRope)
    const float* __restrict__ ckv_new,    // (B, S, kR)
    const float* __restrict__ krope_new,  // (B, S, kRope)
    T* ckv_pages,                         // (n_pages, page, kR)
    T* krope_pages,                       // (n_pages, page, kRope)
    const int* __restrict__ block_table,  // (B, max_pages)
    const int* __restrict__ pos0_arr,     // (B,)
    const int* __restrict__ clen_arr,     // (B,)
    float* __restrict__ out,              // (B, S, H, kR)      one split
    float* __restrict__ m_ws,             // (B, n_split, S * H)
    float* __restrict__ l_ws,
    float* __restrict__ acc_ws,           // (B, n_split, S * H, kR)
    int S, int H, int page, int max_pages, float scale, int n_split) {
  constexpr int ST = kST<T>, EC = repro_page::kPerChunk<T>, CK = kCK<T>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // kRows x kQST
  float* x_s = q_s + kRows * kQST;                // partial logits
  T* k_s = reinterpret_cast<T*>(x_s + kXS);       // 2 x kKeys x ST

  const int b = blockIdx.x;
  const int n_rt = gridDim.y;
  const int rt = n_rt - 1 - (int)blockIdx.y;      // last row tiles first
  const int split_id = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int pos0 = pos0_arr[b], n_tok = clen_arr[b];
  const int R = S * H;
  const int r0 = rt * kRows;
  const int r_end = min(r0 + kRows, R);
  const int live_end = min(r_end, n_tok * H);    // live rows: [r0, live_end)
  const int* table = block_table + (long long)b * max_pages;
  const bool direct = n_split == 1;

  // ---- phase 1: chunk rows into the pages, by split 0 of the row tile
  //      holding the position's first row ----
  if (split_id == 0) {
    const int i_lo = (r0 + H - 1) / H;
    const int i_hi = min((r0 + kRows + H - 1) / H, n_tok);
    for (int e = tid; e < (i_hi - i_lo) * kC4; e += kThreads) {
      const int i = i_lo + e / kC4, c = e % kC4;
      const int pos = pos0 + i;
      if (pos / page >= max_pages) continue;
      const long long dst = (long long)table[pos / page] * page + pos % page;
      const long long src = (long long)b * S + i;
      if (c < kR / 4)
        store4(ckv_pages + dst * kR + 4 * c,
               load4(ckv_new + src * kR + 4 * c));
      else
        store4(krope_pages + dst * kRope + 4 * (c - kR / 4),
               load4(krope_new + src * kRope + 4 * (c - kR / 4)));
    }
  }

  // ---- padded rows of this tile are zeros (the merge writes them when
  //      the keys are split) ----
  float* out_b = out + (long long)b * R * kR;
  if (direct) {
    const int z0 = max(live_end, r0);
    for (int e = tid; e < (r_end - z0) * (kR / 4); e += kThreads)
      reinterpret_cast<float4*>(out_b + (long long)z0 * kR)[e] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (live_end <= r0) return;

  // ---- the key range of the tile's live rows, and this split's share ----
  const int k_hi = pos0 + (live_end - 1) / H + 1;  // keys [0, k_hi)
  const int n_tiles = (k_hi + kKeys - 1) / kKeys;
  const int t_lo = (int)((long long)split_id * n_tiles / n_split);
  const int t_hi = (int)((long long)(split_id + 1) * n_tiles / n_split);

  // kTPK loader threads per key row, each with CK / kTPK chunks strided
  // by kTPK (neighbouring threads on neighbouring 16 bytes): chunks
  // c < kR / EC come from the ckv row, the rest from the krope row
  const int ld_row = tid / kTPK, ld_c = tid % kTPK;
  auto load_tile = [&](int t, int buf) {
    const int pos = t * kKeys + ld_row;
    T* d = k_s + (buf * kKeys + ld_row) * ST;
    if (pos >= pos0 && pos < k_hi && !repro_page::kSmallHalf<T>) {
      // 16-bit: the chunk's own rows, rounded in registers and staged
      const long long src = (long long)b * S + (pos - pos0);
#pragma unroll
      for (int j = 0; j < CK / kTPK; ++j) {
        const int c = ld_c + kTPK * j;
        stage_rounded(d + EC * c, c < kR / EC
                                      ? ckv_new + src * kR + EC * c
                                      : krope_new + src * kRope + EC * c - kR);
      }
      return;
    }
    const T* cs = ckv_pages;
    const T* rs = krope_pages;
    bool pred = false;
    if (pos < pos0) {              // history: pages this launch never writes
      const long long row = (long long)table[pos / page] * page + pos % page;
      cs = ckv_pages + row * kR;
      rs = krope_pages + row * kRope;
      pred = true;
    } else if (pos < k_hi) {       // fp32: the chunk itself, copied as it is
      const long long src = (long long)b * S + (pos - pos0);
      cs = reinterpret_cast<const T*>(ckv_new + src * kR);
      rs = reinterpret_cast<const T*>(krope_new + src * kRope);
      pred = true;
    }
#pragma unroll
    for (int j = 0; j < CK / kTPK; ++j) {
      const int c = ld_c + kTPK * j;
      const T* src = c < kR / EC ? cs + EC * c : rs + EC * c - kR;
      cp_async16(d + EC * c, pred ? src : ckv_pages, pred);
    }
  };

  // query rows [q_lat | q_rope], zeros past the live rows; with the first
  // key tile
  for (int e = tid; e < kRows * kC4; e += kThreads) {
    const int rr = e / kC4, c = e % kC4;
    const long long row = (long long)b * R + r0 + rr;
    const bool live = r0 + rr < live_end;
    const float* src = c < kR / 4 ? q_lat + row * kR + 4 * c
                                  : q_rope + row * kRope + 4 * (c - kR / 4);
    cp_async16(q_s + rr * kQST + 4 * c, live ? src : q_lat, live);
  }
  if (t_lo < t_hi) load_tile(t_lo, 0);
  cp_async_commit();

  // warp roles: row group rg; for the logits key half kn and depth half
  // kd; for the context output columns [128 cw, 128 cw + 128)
  const int rg = warp / kCW, cw = warp % kCW;
  const int kn = cw >> 1, kd = cw & 1;
  const int wr = rg * 16;
  const bool warp_live = r0 + wr < live_end;
  const int qpos0 = pos0 + (r0 + wr + gq) / H;     // this thread's two rows
  const int qpos1 = pos0 + (r0 + wr + gq + 8) / H;
  float* xg = x_s + rg * kCW * 2 * 4 * 32;          // the row group's partials
  float o[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t + 1 < t_hi) load_tile(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();               // tile t (and the queries) landed
    __syncthreads();
    const T* kt = k_s + buf * kKeys * ST;
    if (warp_live) {
      // partial logits: 16 rows x keys 16 kn + [0, 16) over depth
      // 288 kd + [0, 288), accumulated by k-step parity
      float sp[2][2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sp[p][j][0] = sp[p][j][1] = sp[p][j][2] = sp[p][j][3] = 0.f;
      const float* qw = q_s + wr * kQST;
      const T* kr = kt + (16 * kn + gq) * ST + tq;
#pragma unroll 4
      for (int kk = kd * kKS; kk < (kd + 1) * kKS; ++kk) {
        uint32_t ab[4], as[4];
        load_a(qw, kQST, 8 * kk, gq, tq, ab, as);
        float kb2[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          kb2[j][0] = to_f32(kr[8 * j * ST + 8 * kk]);
          kb2[j][1] = to_f32(kr[8 * j * ST + 8 * kk + 4]);
        }
        mma3<2, repro_page::kSmallHalf<T>>(sp[kk & 1], ab, as, kb2);
      }
      float* xw = xg + cw * 2 * 4 * 32;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xw[(j * 4 + e) * 32 + lane] = sp[0][j][e] + sp[1][j][e];
    }
    __syncthreads();                 // the partial logits are in x_s
    if (warp_live) {
      // the whole 16 x 32 tile: key n-tile j from key half j / 2, the two
      // depth halves summed in the same order by every warp
      const int kb0 = t * kKeys;
      float s[kNJ][4];
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float* x0 = xg + ((j >> 1) * 2) * 2 * 4 * 32 + (j & 1) * 4 * 32;
        const float* x1 = x0 + 2 * 4 * 32;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kb0 + 8 * j + 2 * tq + (e & 1);
          const float x = x0[e * 32 + lane] + x1[e * 32 + lane];
          s[j][e] = kpos <= (e < 2 ? qpos0 : qpos1) ? x * scale : kNegInf;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float al0 = __expf(m0 - mx0), al1 = __expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
      // context: P (16 x 32) against the tile's ckv columns
      // [128 cw, 128 cw + 128)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float p0 = s[j][0] > 0.5f * kNegInf ? __expf(s[j][0] - mx0) : 0.f;
        const float p1 = s[j][1] > 0.5f * kNegInf ? __expf(s[j][1] - mx0) : 0.f;
        const float p2 = s[j][2] > 0.5f * kNegInf ? __expf(s[j][2] - mx1) : 0.f;
        const float p3 = s[j][3] > 0.5f * kNegInf ? __expf(s[j][3] - mx1) : 0.f;
        l0 += p0 + p1;
        l1 += p2 + p3;
        uint32_t ab[4], as[4];
        p_fragment(p0, p1, p2, p3, ab, as);
        const T* v0 = kt + (8 * j + 2 * tq) * ST + 128 * cw + gq;
#pragma unroll
        for (int n0 = 0; n0 < kNO; n0 += 4) {   // 4 output n-tiles at a time
          float vb2[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            vb2[n][0] = to_f32(v0[8 * (n0 + n)]);
            vb2[n][1] = to_f32(v0[ST + 8 * (n0 + n)]);
          }
          mma3<4, repro_page::kSmallHalf<T>>(
              *reinterpret_cast<float(*)[4][4]>(&o[n0]), ab, as, vb2);
        }
      }
    }
    __syncthreads();                 // buffer buf and x_s free again
  }
  cp_async_wait_all();               // an empty share still staged the queries

  if (!warp_live) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + wr + gq + 8 * half;
    if (r >= live_end) continue;
    const float l = half ? l1 : l0;
    const int col = 128 * cw + 2 * tq;
    if (direct) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      float* orow = out_b + (long long)r * kR + col;
#pragma unroll
      for (int n = 0; n < kNO; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    } else {
      const long long w = ((long long)b * n_split + split_id) * R + r;
      if (cw == 0 && tq == 0) {
        m_ws[w] = half ? m1 : m0;
        l_ws[w] = l;
      }
      float* arow = acc_ws + w * kR + col;
#pragma unroll
      for (int n = 0; n < kNO; ++n)
        *reinterpret_cast<float2*>(arow + 8 * n) =
            make_float2(o[n][2 * half], o[n][2 * half + 1]);
    }
  }
}

template <typename T>
int mla_prefill(const float* q_lat, const float* q_rope, const float* ckv_new,
                const float* krope_new, T* ckv_pages, T* krope_pages,
                const int* block_table, const int* pos0, const int* chunk_len,
                float* out, float* m_ws, float* l_ws, float* acc_ws, int B,
                int S, int H, int r, int rope, int page, int max_pages,
                float scale, int n_split, void* stream) {
  const long long tiles = ((long long)S * H + kRows - 1) / kRows;
  if (r != kR || rope != kRope || tiles > 65535 || n_split < 1 ||
      n_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        mla_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem<T>);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  mla_prefill_kernel<T><<<dim3(B, (unsigned)tiles, n_split), kThreads,
                          kSmem<T>, st>>>(
      q_lat, q_rope, ckv_new, krope_new, ckv_pages, krope_pages, block_table,
      pos0, chunk_len, out, m_ws, l_ws, acc_ws, S, H, page, max_pages, scale,
      n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return repro_split::launch_split_merge(m_ws, l_ws, acc_ws, chunk_len, out,
                                         B, S, H, 1, kR, n_split, st);
}

}  // namespace

// n_split: key splits per row tile (the wrapper's n_splits), with m_ws /
// l_ws (B, n_split, S * H) and acc_ws (B, n_split, S * H, r) when it is
// above 1 (null otherwise).  Returns 0 or a CUDA error code;
// cudaErrorInvalidValue for latent widths other than r 512, rope 64 or a
// grid the card cannot launch.  _f32 takes float32 pages, _bf16 bfloat16
// pages, _f16 float16 pages.
extern "C" int repro_mla_paged_prefill_f32(
    const float* q_lat, const float* q_rope, const float* ckv_new,
    const float* krope_new, float* ckv_pages, float* krope_pages,
    const int* block_table, const int* pos0, const int* chunk_len, float* out,
    float* m_ws, float* l_ws, float* acc_ws, int B, int S, int H, int r,
    int rope, int page, int max_pages, float scale, int n_split,
    void* stream) {
  return mla_prefill<float>(q_lat, q_rope, ckv_new, krope_new, ckv_pages,
                            krope_pages, block_table, pos0, chunk_len, out,
                            m_ws, l_ws, acc_ws, B, S, H, r, rope, page,
                            max_pages, scale, n_split, stream);
}

extern "C" int repro_mla_paged_prefill_bf16(
    const float* q_lat, const float* q_rope, const float* ckv_new,
    const float* krope_new, bf16* ckv_pages, bf16* krope_pages,
    const int* block_table, const int* pos0, const int* chunk_len, float* out,
    float* m_ws, float* l_ws, float* acc_ws, int B, int S, int H, int r,
    int rope, int page, int max_pages, float scale, int n_split,
    void* stream) {
  return mla_prefill<bf16>(q_lat, q_rope, ckv_new, krope_new, ckv_pages,
                           krope_pages, block_table, pos0, chunk_len, out,
                           m_ws, l_ws, acc_ws, B, S, H, r, rope, page,
                           max_pages, scale, n_split, stream);
}

extern "C" int repro_mla_paged_prefill_f16(
    const float* q_lat, const float* q_rope, const float* ckv_new,
    const float* krope_new, f16* ckv_pages, f16* krope_pages,
    const int* block_table, const int* pos0, const int* chunk_len, float* out,
    float* m_ws, float* l_ws, float* acc_ws, int B, int S, int H, int r,
    int rope, int page, int max_pages, float scale, int n_split,
    void* stream) {
  return mla_prefill<f16>(q_lat, q_rope, ckv_new, krope_new, ckv_pages,
                          krope_pages, block_table, pos0, chunk_len, out,
                          m_ws, l_ws, acc_ws, B, S, H, r, rope, page,
                          max_pages, scale, n_split, stream);
}
