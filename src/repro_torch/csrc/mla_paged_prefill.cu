// Fused MLA latent-page chunked prefill for Hopper (sm_90a), float32.
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
// query position of the chunk, so the work sits far above the float32
// ridge: it is bound by operations, float32 FMAs outside the tensor cores
// in this version (67 TFLOP/s peak).
//
// What the design does about it:
//  * Rows are folded position-major (row i * H + h is position i, head h)
//    and a block takes 16 consecutive rows, so the rows of a block share
//    one causal limit (deepseek's 128 heads give 8 blocks per position)
//    and the grid (lane, row tile) has thousands of blocks per chunk.
//  * A block stages 16 keys at a time (16 x 576 floats = 36 KB of shared
//    memory) and every one of its 16 rows uses them: each key is loaded
//    from device memory or L2 once per block, not once per row.
//  * The queries and the accumulators live in REGISTERS, not in shared
//    memory.  A warp owns 4 rows; lane l holds, for each of its 4 rows,
//    the latent columns j * 128 + 4 l + [0, 4) (j < 4) and the rope columns
//    2 l + [0, 2) of the query (72 floats) and the same latent columns of
//    the accumulator (64 floats).  A row's 512-float accumulator is thus
//    spread over the 32 lanes of its warp, 16 floats each.  Shared memory
//    would cost two extra loads per FMA (the accumulator and the query are
//    touched for every key); registers cost nothing per use, and the key
//    tile is the only operand read from shared memory.  About 190
//    registers a thread, so two 128-thread blocks per SM.
//  * Scores: each lane forms partial dot products over its 18 columns for
//    4 rows x 8 keys, then one reduce-scatter of the 32 partials over the
//    warp (31 shuffles) leaves lane l with the full score of row l / 8,
//    key l % 8.  The online-softmax update of a row runs on its 8 lanes.
//  * Tensor cores (wgmma) and TMA loads of the key tiles are later work.
//
// The hazard the TPU kernel avoided by program order within a lane: here
// the row tiles of one lane run in parallel, so no block reads a position
// that another block may be writing.  Keys below pos0 (the history) are
// read from the pages, which this launch never writes at those positions;
// keys of the chunk itself come straight from ckv_new / krope_new.  The
// lane's blocks share the writes, position i going to block i mod the
// number of blocks, so every row is written exactly once.  Pages written by
// different lanes are exclusive after the engine's copy-on-write barrier
// (PagedKVManager.ensure_writable); a masked lane (chunk_len 0) aliases
// another lane's table and writes nothing.
//
// Output rows at i >= chunk_len[b] (padding, masked lanes) are zeros.
// Masked scores are NEG_INF = -1e30 and contribute an exact 0 (their
// probability is set to 0, never computed), and the denominator is
// floored at 1e-30, as in the TPU kernel.  scale is an argument
// ((qk_nope + rope)^-0.5 for deepseek-v2).
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kR = 512;                  // kv_lora_rank the kernel is built for
constexpr int kRope = 64;                // qk_rope_head_dim
constexpr int kD = kR + kRope;           // floats per staged key
constexpr int kLat = kR / 128;           // float4 latent chunks per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kKeys = 16;                // keys per staged tile
constexpr int kSub = 8;                  // keys per score reduce-scatter
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRowsPerWarp * kSub == 32, "one score per lane after reduce");
static_assert(kKeys == 2 * kSub, "two reduce-scatters per key tile");
static_assert(kRope == 64, "rope columns are one float2 per lane");

// One step of the reduce-scatter: lanes with bit `half` set keep the upper
// half of the values and send the lower half to their partner, and the
// other way round; afterwards v[0, half) holds sums over both lanes.
template <int half>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool upper = (lane & half) != 0;
#pragma unroll
  for (int j = 0; j < half; ++j) {
    const float send = upper ? v[j] : v[j + half];
    const float keep = upper ? v[j + half] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, half);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads, 2) mla_prefill_kernel(
    const float* __restrict__ q_lat,      // (B, S, H, kR)
    const float* __restrict__ q_rope,     // (B, S, H, kRope)
    const float* __restrict__ ckv_new,    // (B, S, kR)
    const float* __restrict__ krope_new,  // (B, S, kRope)
    float* ckv_pages,                     // (n_pages, page, kR)
    float* krope_pages,                   // (n_pages, page, kRope)
    const int* __restrict__ block_table,  // (B, max_pages)
    const int* __restrict__ pos0_arr,     // (B,)
    const int* __restrict__ clen_arr,     // (B,)
    float* __restrict__ out,              // (B, S, H, kR)
    int S, int H, int page, int max_pages, float scale) {
  __shared__ __align__(16) float k_s[kKeys * kD];
  __shared__ float p_s[kWarps * kRowsPerWarp * kKeys];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pos0 = pos0_arr[b];
  const int n_tok = clen_arr[b];
  const long long n_rows = (long long)S * H;
  const int* table = block_table + (long long)b * max_pages;

  // ---- phase 1: the chunk's latent rows into the pages, shared out ----
  for (int i = blockIdx.y; i < n_tok; i += gridDim.y) {
    const int pos = pos0 + i;
    const int slot = pos / page;
    if (slot >= max_pages) break;
    const long long dst = (long long)table[slot] * page + pos % page;
    const long long src = (long long)b * S + i;
    for (int e = tid; e < kD / 4; e += kThreads) {
      float4* d = e < kR / 4
          ? reinterpret_cast<float4*>(ckv_pages + dst * kR) + e
          : reinterpret_cast<float4*>(krope_pages + dst * kRope) + (e - kR / 4);
      *d = e < kR / 4 ? ld4(ckv_new + src * kR + 4 * e)
                      : ld4(krope_new + src * kRope + 4 * (e - kR / 4));
    }
  }

  // ---- this block's rows ----
  const long long row0 = (long long)blockIdx.y * kRows;
  const long long row_end = row0 + kRows < n_rows ? row0 + kRows : n_rows;
  float* out_b = out + (long long)b * n_rows * kR;
  if (row0 / H >= n_tok) {  // no live row: padding, or a masked lane
    for (long long e = tid; e < (row_end - row0) * (kR / 4); e += kThreads)
      reinterpret_cast<float4*>(out_b + row0 * kR)[e] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  int i_last = (int)((row_end - 1) / H);
  if (i_last > n_tok - 1) i_last = n_tok - 1;
  const int kv_len = pos0 + n_tok;
  const int key_end = pos0 + i_last + 1;  // keys [0, key_end) are visible

  float4 ql[kRowsPerWarp][kLat];
  float2 qr[kRowsPerWarp];
  float4 acc[kRowsPerWarp][kLat];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const long long row = row0 + warp * kRowsPerWarp + rr;
    const bool live = row < row_end && row / H < n_tok;
    const long long q_off = (long long)b * n_rows + row;
#pragma unroll
    for (int j = 0; j < kLat; ++j) {
      ql[rr][j] = live ? ld4(q_lat + q_off * kR + j * 128 + 4 * lane)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[rr][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    qr[rr] = live ? *reinterpret_cast<const float2*>(q_rope + q_off * kRope
                                                     + 2 * lane)
                  : make_float2(0.f, 0.f);
  }
  // the row whose softmax state this lane keeps (lane / 8 of the warp's 4)
  const long long my_row = row0 + warp * kRowsPerWarp + lane / kSub;
  const bool my_live = my_row < row_end && my_row / H < n_tok;
  const int my_qpos = pos0 + (int)(my_row / H);
  float m_run = kNegInf, l_run = 0.f;
  float* p_w = p_s + warp * kRowsPerWarp * kKeys;

  for (int t0 = 0; t0 < key_end; t0 += kKeys) {
    __syncthreads();  // the previous tile's keys are consumed
    for (int e = tid; e < kKeys * (kD / 4); e += kThreads) {
      const int k = e / (kD / 4), c4 = e % (kD / 4);
      const int pos = t0 + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pos < pos0) {  // history: positions this launch never writes
        const long long row = (long long)table[pos / page] * page + pos % page;
        v = c4 < kR / 4 ? ld4(ckv_pages + row * kR + 4 * c4)
                        : ld4(krope_pages + row * kRope + 4 * (c4 - kR / 4));
      } else if (pos < kv_len) {  // the chunk itself: from the new rows
        const long long src = (long long)b * S + (pos - pos0);
        v = c4 < kR / 4 ? ld4(ckv_new + src * kR + 4 * c4)
                        : ld4(krope_new + src * kRope + 4 * (c4 - kR / 4));
      }
      reinterpret_cast<float4*>(k_s + k * kD)[c4] = v;
    }
    __syncthreads();

    // scores: lane ends with row lane / 8, keys sb * 8 + lane % 8
    float s_mine[2];
    bool valid[2];
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {
      float v[32];
#pragma unroll
      for (int kk = 0; kk < kSub; ++kk) {
        const float* kr = k_s + (sb * kSub + kk) * kD;
        float4 kv[kLat];
#pragma unroll
        for (int j = 0; j < kLat; ++j) kv[j] = ld4(kr + j * 128 + 4 * lane);
        const float2 kp = *reinterpret_cast<const float2*>(kr + kR + 2 * lane);
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          float d = qr[rr].x * kp.x;
          d = fmaf(qr[rr].y, kp.y, d);
#pragma unroll
          for (int j = 0; j < kLat; ++j) {
            d = fmaf(ql[rr][j].x, kv[j].x, d);
            d = fmaf(ql[rr][j].y, kv[j].y, d);
            d = fmaf(ql[rr][j].z, kv[j].z, d);
            d = fmaf(ql[rr][j].w, kv[j].w, d);
          }
          v[rr * kSub + kk] = d;
        }
      }
      reduce_scatter_step<16>(v, lane);
      reduce_scatter_step<8>(v, lane);
      reduce_scatter_step<4>(v, lane);
      reduce_scatter_step<2>(v, lane);
      reduce_scatter_step<1>(v, lane);
      const int k_pos = t0 + sb * kSub + lane % kSub;
      valid[sb] = my_live && k_pos <= my_qpos && k_pos < kv_len;
      s_mine[sb] = valid[sb] ? v[0] * scale : kNegInf;
    }

    // online softmax of each row over its 8 lanes
    float mx = fmaxf(s_mine[0], s_mine[1]);
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
    const float m_new = fmaxf(m_run, mx);
    const float p0 = valid[0] ? expf(s_mine[0] - m_new) : 0.f;
    const float p1 = valid[1] ? expf(s_mine[1] - m_new) : 0.f;
    float sum = p0 + p1;
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    sum += __shfl_xor_sync(kFull, sum, 4);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    p_w[(lane / kSub) * kKeys + lane % kSub] = p0;
    p_w[(lane / kSub) * kKeys + kSub + lane % kSub] = p1;
    __syncwarp();

    // context: acc = acc * alpha + p . ckv over the tile
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const float a = __shfl_sync(kFull, alpha, rr * kSub);
#pragma unroll
      for (int j = 0; j < kLat; ++j) {
        acc[rr][j].x *= a;
        acc[rr][j].y *= a;
        acc[rr][j].z *= a;
        acc[rr][j].w *= a;
      }
    }
#pragma unroll 4
    for (int k = 0; k < kKeys; ++k) {
      const float* kr = k_s + k * kD;
      float4 cv[kLat];
#pragma unroll
      for (int j = 0; j < kLat; ++j) cv[j] = ld4(kr + j * 128 + 4 * lane);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float p = p_w[rr * kKeys + k];
#pragma unroll
        for (int j = 0; j < kLat; ++j) {
          acc[rr][j].x = fmaf(p, cv[j].x, acc[rr][j].x);
          acc[rr][j].y = fmaf(p, cv[j].y, acc[rr][j].y);
          acc[rr][j].z = fmaf(p, cv[j].z, acc[rr][j].z);
          acc[rr][j].w = fmaf(p, cv[j].w, acc[rr][j].w);
        }
      }
    }
    __syncwarp();  // p_w is rewritten by the next tile
  }

  // ---- epilogue: normalise live rows, zero the padded ones ----
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const float l = __shfl_sync(kFull, l_run, rr * kSub);
    const long long row = row0 + warp * kRowsPerWarp + rr;
    if (row >= row_end) continue;
    const bool live = row / H < n_tok;
    const float inv = live ? 1.f / fmaxf(l, 1e-30f) : 0.f;
#pragma unroll
    for (int j = 0; j < kLat; ++j) {
      float4 o = acc[rr][j];
      o.x *= inv;
      o.y *= inv;
      o.z *= inv;
      o.w *= inv;
      *reinterpret_cast<float4*>(out_b + row * kR + j * 128 + 4 * lane) = o;
    }
  }
}

}  // namespace

extern "C" int repro_mla_paged_prefill_f32(
    const float* q_lat, const float* q_rope, const float* ckv_new,
    const float* krope_new, float* ckv_pages, float* krope_pages,
    const int* block_table, const int* pos0, const int* chunk_len, float* out,
    int B, int S, int H, int r, int rope, int page, int max_pages, float scale,
    void* stream) {
  const long long tiles = ((long long)S * H + kRows - 1) / kRows;
  if (r != kR || rope != kRope || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B, (unsigned)tiles);
  mla_prefill_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      q_lat, q_rope, ckv_new, krope_new, ckv_pages, krope_pages, block_table,
      pos0, chunk_len, out, S, H, page, max_pages, scale);
  return (int)cudaGetLastError();
}
