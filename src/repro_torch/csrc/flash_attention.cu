// Dense flash attention for Hopper (sm_90a), float32 or bfloat16 data,
// products on the tensor cores in 3xTF32.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bh
// (Pallas body _flash_kernel).  Heads are pre-flattened and GQA
// pre-expanded by the caller: q (BH, Sq, hd), k/v (BH, Sk, hd), out
// (BH, Sq, hd).  Key j is visible to query row i iff j < kv_len and, when
// causal, j <= q_offset + i.  Masked scores are NEG_INF = -1e30 and
// contribute exactly 0, the softmax denominator is floored at 1e-30,
// accumulation is float32, as in the TPU kernel.  Sq and Sk need not be
// multiples of any tile (whisper's encoder has 1500 frames = 23 x 64 + 28);
// the TPU wrapper pads to 128-row blocks, this kernel masks the ragged
// edges itself.  A row with no visible key gets zeros.
//
// What bounds it on an H100: operations at the encoder's shape (Sq = Sk =
// 1500, hd 64: 4 hd flops per visible (row, key) pair, 576 flops a byte
// of q/k/v/out), bytes at a cross-attention decode step (Sq 1: every key
// and value is read once for one row).
//
// What the design does about it:
// - Tensor cores: Q·Kᵀ and P·V are mma.sync.m16n8k8 TF32 products in
//   3xTF32, as in B2 (csrc/paged_prefill.cu; helpers in mma_tf32.cuh).
//   The score fragment feeds P·V as the A operand with no data movement.
// - A block has 8 warps and stages 64-key K/V tiles by 16-byte cp.async,
//   double-buffered (tile t + 1 in flight while tile t is computed), rows
//   padded to hd + 4 floats so that the fragment reads fall on 32 banks
//   (at zamba2's hd 112 too: csrc/paged_prefill.cu).  P·V takes its hd / 8
//   output n-tiles four at a time and then the rest (pv_mma3).
//   Keys past the tile range are zero-filled, never read.
// - Two regimes, by rows (template KW, warps per row group):
//   * many rows (Sq > 64; the encoder, long cross-prefill chunks): KW 1,
//     8 warps x 16 rows = 128 query rows of one bh per block, each warp
//     over every key of the tile (12 query tiles x 20 heads = 240 blocks
//     at the encoder's shape);
//   * few rows (cross-decode, Sq 1; short cross-prefill chunks): 16 x
//     8 / KW rows per block, KW = 2, 4 or 8 warps sharing a row group,
//     each over its own 64 / KW keys of every tile, so every warp has work
//     even at Sq 1.  The KW partial (m, l, acc) of a row group are merged
//     in shared memory at the end.
// - Key split: where it shortens the grid (the wrapper's n_splits: one
//   lane's cross-decode step, 20 blocks alone, takes 6 splits; the
//   encoder none), each tile's key range is split over n_split blocks;
//   each takes a balanced share of the tile's 64-key tiles, writes its
//   partial (m, l, acc) (l = 0 and acc zeros when its share is empty),
//   and split_merge.cuh's launch merges them into out, seen as (B = BH,
//   S = Sq, H = 1, hd).  With one split the block writes the output.
// - Causal: query tiles are launched last first across all bh (they see
//   the most keys), and key tiles past a tile's last visible key are never
//   visited.
// - bf16 q, k and v (the launch layer's bf16 steps: whisper's encoder and
//   cross attention; the reference's all-bf16 kernel case): K/V tiles are
//   staged by cp.async as bf16, rows padded to hd + 8 elements (B2's bf16
//   layout, conflict-free fragment reads: csrc/paged_prefill.cu), and
//   widened to fp32 as fragments are read; a bf16 value is exact in TF32,
//   so both products skip the key's or value's small half.  The query rows
//   are widened to fp32 as they are staged (plain loads).  The output is
//   rounded to bf16 once, from the fp32 result (split_merge.cuh rounds it
//   when the keys are split), as the Pallas kernel's o.astype(q.dtype).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "page_types.cuh"
#include "split_merge.cuh"

namespace {

using repro_mma::cp_async16;
using repro_mma::cp_async_commit;
using repro_mma::cp_async_wait_1;
using repro_mma::cp_async_wait_all;
using repro_mma::load_a;
using repro_mma::mma3;
using repro_mma::p_fragment;
using repro_mma::pv_mma3;
using repro_mma::quad_max;
using repro_mma::quad_sum;
using repro_page::bf16;
using repro_page::kPerChunk;
using repro_page::kSmallHalf;
using repro_page::load4;
using repro_page::store2;
using repro_page::to_f32;
using repro_split::kNegInf;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 64;           // keys per tile

// fp32 query rows of hd + 4 floats; K/V tiles of T rows padded by one
// 16-byte chunk (hd + 4 floats, hd + 8 bf16)
template <typename T, int HD, int KW>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(16 * (kWarps / KW)) * (HD + 4) +
         sizeof(T) * (size_t)(4 * kBN) * (HD + kPerChunk<T>);
}

template <typename T, int HD, int KW>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,        // (BH, Sq, HD)
    const T* __restrict__ k,        // (BH, Sk, HD)
    const T* __restrict__ v,        // (BH, Sk, HD)
    T* __restrict__ out,            // (BH, Sq, HD)             one split
    float* __restrict__ m_ws,       // (BH, n_split, Sq)
    float* __restrict__ l_ws,
    float* __restrict__ acc_ws,     // (BH, n_split, Sq, HD)
    int Sq, int Sk, int causal, int q_offset, int kv_len, float scale,
    int n_split) {
  constexpr int ST = HD + 4;        // shared query row stride in floats
  constexpr int C4 = HD / 4;        // fp32 16-byte chunks per query row
  constexpr int EC = kPerChunk<T>;  // elements per 16 bytes
  constexpr int KST = HD + EC;      // shared K/V row stride in elements
  constexpr int CK = HD / EC;       // 16-byte chunks per K/V row
  constexpr int NK = HD / 8;        // k-steps of Q·Kᵀ, n-tiles of P·V
  constexpr int RW = kWarps / KW;   // row groups of 16 per block
  constexpr int BM = 16 * RW;       // query rows per block
  constexpr int NJ = kBN / 8 / KW;  // a warp's n-tiles of a key tile
  constexpr int NP = NJ <= 2 ? 2 : 1;  // Q·Kᵀ accumulators by k-step parity
  // the KW > 1 merge's scratch (every warp's fragments) reuses the tiles
  static_assert(sizeof(float) * kWarps * (NK * 4 + 4) * 32 <=
                    sizeof(T) * 4 * kBN * KST,
                "the warps' partials fit in the K/V tiles");
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // BM x ST
  T* k_s = reinterpret_cast<T*>(q_s + BM * ST);   // 2 x kBN x KST
  T* v_s = k_s + 2 * kBN * KST;                   // 2 x kBN x KST

  const long long bh = blockIdx.x;
  const int n_qt = gridDim.y / n_split;
  const int qt = n_qt - 1 - (int)blockIdx.y / n_split;
  const int split_id = blockIdx.y % n_split;
  const int r0 = qt * BM;
  const int r_end = min(r0 + BM, Sq);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rw = warp / KW, kw = warp % KW;
  const T* qb = q + bh * Sq * HD;
  const T* kb = k + bh * Sk * HD;
  const T* vb = v + bh * Sk * HD;

  // the keys any row of this tile may see: [0, k_hi), and this split's
  // share of its 64-key tiles
  const int n_k = min(kv_len, Sk);
  const int k_hi = causal ? min(n_k, q_offset + r_end) : n_k;
  const int n_tiles = k_hi > 0 ? (k_hi + kBN - 1) / kBN : 0;
  const int t_lo = (int)((long long)split_id * n_tiles / n_split);
  const int t_hi = (int)((long long)(split_id + 1) * n_tiles / n_split);

  // a tile's kBN key rows: kTPK threads per row, each issuing its share of
  // the row's 16-byte copies (fp32: a run of C4 / kTPK; bf16 rows at hd 112
  // have 14 chunks, so every kTPK-th one)
  constexpr int kTPK = kThreads / kBN;
  constexpr int kCPT = (CK + kTPK - 1) / kTPK;  // chunks per thread, at most
  static_assert(kTPK * kBN == kThreads, "tile split");
  const int ld_p = tid / kTPK;
  const int ld_c = tid % kTPK;
  auto load_tile = [&](int t, int buf) {
    const int pos = t * kBN + ld_p;
    const bool pred = pos < k_hi;
    const long long off = pred ? (long long)pos * HD : 0;
    T* kd = k_s + buf * kBN * KST + ld_p * KST;
    T* vd = v_s + buf * kBN * KST + ld_p * KST;
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const int c = CK % kTPK == 0 ? ld_c * kCPT + j : ld_c + kTPK * j;
      if (c < CK) {
        cp_async16(kd + EC * c, kb + off + (pred ? EC * c : 0), pred);
        cp_async16(vd + EC * c, vb + off + (pred ? EC * c : 0), pred);
      }
    }
  };

  // query rows, zeros past Sq; with the first key tile (bf16 rows are
  // widened by plain loads: the loop's first barrier publishes them)
  for (int e = tid; e < BM * C4; e += kThreads) {
    const int rr = e / C4, c = e % C4;
    const bool live = r0 + rr < Sq;
    const T* src = live ? qb + (long long)(r0 + rr) * HD + 4 * c : qb;
    if constexpr (kSmallHalf<T>) {
      cp_async16(q_s + rr * ST + 4 * c, src, live);
    } else {
      *reinterpret_cast<float4*>(q_s + rr * ST + 4 * c) =
          live ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (t_lo < t_hi) load_tile(t_lo, 0);
  cp_async_commit();

  // this thread's two rows: wr + gq and wr + gq + 8 of the tile, and the
  // keys each may see: [0, lim)
  const int wr = rw * 16;
  const int lim0 = causal ? min(n_k, q_offset + r0 + wr + gq + 1) : n_k;
  const int lim1 = causal ? min(n_k, q_offset + r0 + wr + gq + 9) : n_k;
  float o[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const bool warp_live = r0 + wr < r_end;

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t + 1 < t_hi) load_tile(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();               // tile t (and the queries) landed
    __syncthreads();
    if (warp_live) {
      // this warp's keys of the tile: n-tiles kw * NJ + [0, NJ)
      const T* kt = k_s + buf * kBN * KST + kw * NJ * 8 * KST;
      const T* vt = v_s + buf * kBN * KST + kw * NJ * 8 * KST;
      const float* qw = q_s + wr * ST;
      float sp[NP][NJ][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          sp[p][j][0] = sp[p][j][1] = sp[p][j][2] = sp[p][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t ab[4], as[4];
        load_a(qw, ST, 8 * kk, gq, tq, ab, as);
        float kb2[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const T* kr = kt + (8 * j + gq) * KST + 8 * kk + tq;
          kb2[j][0] = to_f32(kr[0]);
          kb2[j][1] = to_f32(kr[4]);
        }
        mma3<NJ, kSmallHalf<T>>(sp[kk % NP], ab, as, kb2);
      }
      // mask, scale, online softmax on the fragments
      const int kb0 = t * kBN + kw * NJ * 8;
      float s[NJ][4];
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = NP == 2 ? sp[0][j][e] + sp[NP - 1][j][e] : sp[0][j][e];
          const int kpos = kb0 + 8 * j + 2 * tq + (e & 1);
          s[j][e] = kpos < (e < 2 ? lim0 : lim1) ? x * scale : kNegInf;
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
        uint32_t ab[4], as[4];
        p_fragment(p0, p1, p2, p3, ab, as);
        const T* v0 = vt + (8 * j + 2 * tq) * KST + gq;
        pv_mma3<NK>(o, ab, as, v0, KST);
      }
    }
    __syncthreads();                 // buffer buf free for tile t + 2
  }
  cp_async_wait_all();               // an empty share still staged the queries
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  if (KW > 1) {
    // merge the KW partials of each row group in shared memory (the key
    // tiles are consumed): every warp leaves its (m, l, acc) fragments,
    // the row group's first warp folds in the others in a fixed order
    __syncthreads();
    float* xw = reinterpret_cast<float*>(k_s) + warp * (NK * 4 + 4) * 32;
    if (warp_live && kw > 0) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xw[(n * 4 + e) * 32 + lane] = o[n][e];
      xw[(NK * 4 + 0) * 32 + lane] = m0;
      xw[(NK * 4 + 1) * 32 + lane] = m1;
      xw[(NK * 4 + 2) * 32 + lane] = l0;
      xw[(NK * 4 + 3) * 32 + lane] = l1;
    }
    __syncthreads();
    if (kw > 0 || !warp_live) return;
#pragma unroll 1
    for (int w = 1; w < KW; ++w) {
      const float* xo = xw + w * (NK * 4 + 4) * 32;
      const float mb0 = xo[(NK * 4 + 0) * 32 + lane];
      const float mb1 = xo[(NK * 4 + 1) * 32 + lane];
      const float n0 = fmaxf(m0, mb0), n1 = fmaxf(m1, mb1);
      const float ca0 = __expf(m0 - n0), cb0 = __expf(mb0 - n0);
      const float ca1 = __expf(m1 - n1), cb1 = __expf(mb1 - n1);
      l0 = l0 * ca0 + xo[(NK * 4 + 2) * 32 + lane] * cb0;
      l1 = l1 * ca1 + xo[(NK * 4 + 3) * 32 + lane] * cb1;
      m0 = n0;
      m1 = n1;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        o[n][0] = o[n][0] * ca0 + xo[(n * 4 + 0) * 32 + lane] * cb0;
        o[n][1] = o[n][1] * ca0 + xo[(n * 4 + 1) * 32 + lane] * cb0;
        o[n][2] = o[n][2] * ca1 + xo[(n * 4 + 2) * 32 + lane] * cb1;
        o[n][3] = o[n][3] * ca1 + xo[(n * 4 + 3) * 32 + lane] * cb1;
      }
    }
  } else if (!warp_live) {
    return;
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + wr + gq + 8 * half;
    if (r >= r_end) continue;
    const float l = half ? l1 : l0;
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      T* orow = out + (bh * Sq + r) * HD;
#pragma unroll
      for (int n = 0; n < NK; ++n)
        store2(orow + 8 * n + 2 * tq, o[n][2 * half] * inv,
               o[n][2 * half + 1] * inv);
    } else {
      const long long w = (bh * n_split + split_id) * Sq + r;
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

template <typename T, int HD, int KW>
int launch(const T* q, const T* k, const T* v, T* out, float* m_ws,
           float* l_ws, float* acc_ws, int BH, int Sq, int Sk, int causal,
           int q_offset, int kv_len, float scale, int n_split,
           cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, HD, KW>();
  // the attribute belongs to the instantiation: set it once, not on
  // every launch (as B2 does)
  static bool attr_set = false;
  if (smem > 48 * 1024 && !attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD, KW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  constexpr int BM = 16 * (kWarps / KW);
  const int n_qt = (Sq + BM - 1) / BM;
  if ((long long)n_qt * n_split > 65535) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<T, HD, KW>
      <<<dim3(BH, n_qt * n_split), kThreads, smem, st>>>(
          q, k, v, out, m_ws, l_ws, acc_ws, Sq, Sk, causal, q_offset, kv_len,
          scale, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return repro_split::launch_split_merge(m_ws, l_ws, acc_ws, nullptr, out, BH,
                                         Sq, 1, 1, HD, n_split, st);
}

template <typename T, int HD>
int launch_kw(const T* q, const T* k, const T* v, T* out, float* m_ws,
              float* l_ws, float* acc_ws, int BH, int Sq, int Sk, int causal,
              int q_offset, int kv_len, float scale, int n_split, int kw,
              cudaStream_t st) {
#define REPRO_FLASH_KW(KW)                                                  \
  return launch<T, HD, KW>(q, k, v, out, m_ws, l_ws, acc_ws, BH, Sq, Sk,    \
                           causal, q_offset, kv_len, scale, n_split, st)
  switch (kw) {
    case 1: REPRO_FLASH_KW(1);
    case 2: REPRO_FLASH_KW(2);
    case 4: REPRO_FLASH_KW(4);
    case 8: REPRO_FLASH_KW(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_KW
}

template <typename T>
int flash_attention(const T* q, const T* k, const T* v, T* out, float* m_ws,
                    float* l_ws, float* acc_ws, int BH, int Sq, int Sk,
                    int hd, int causal, int q_offset, int kv_len,
                    float scale, int kw, int n_split, void* stream) {
  if (BH <= 0 || Sq <= 0 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_FLASH_HD(HD)                                                  \
  return launch_kw<T, HD>(q, k, v, out, m_ws, l_ws, acc_ws, BH, Sq, Sk,     \
                          causal, q_offset, kv_len, scale, n_split, kw, s)
  switch (hd) {
    case 32: REPRO_FLASH_HD(32);
    case 64: REPRO_FLASH_HD(64);
    case 112: REPRO_FLASH_HD(112);
    case 128: REPRO_FLASH_HD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_HD
}

}  // namespace

// kw: warps per row group (1, 2, 4 or 8; the wrapper's warps_per_rows);
// n_split: key splits per query tile (the wrapper's n_splits), with
// m_ws / l_ws (BH, n_split, Sq) and acc_ws (BH, n_split, Sq, hd) when it is
// above 1 (null otherwise).  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for a head dim other than 32, 64, 112 or 128, a kw
// outside 1/2/4/8 or a grid the card cannot launch.  _f32 takes float32
// q, k, v and out, _bf16 bf16 ones.
extern "C" int repro_flash_attention_f32(
    const float* q, const float* k, const float* v, float* out, float* m_ws,
    float* l_ws, float* acc_ws, int BH, int Sq, int Sk, int hd, int causal,
    int q_offset, int kv_len, float scale, int kw, int n_split,
    void* stream) {
  return flash_attention<float>(q, k, v, out, m_ws, l_ws, acc_ws, BH, Sq, Sk,
                                hd, causal, q_offset, kv_len, scale, kw,
                                n_split, stream);
}

extern "C" int repro_flash_attention_bf16(
    const bf16* q, const bf16* k, const bf16* v, bf16* out, float* m_ws,
    float* l_ws, float* acc_ws, int BH, int Sq, int Sk, int hd, int causal,
    int q_offset, int kv_len, float scale, int kw, int n_split,
    void* stream) {
  return flash_attention<bf16>(q, k, v, out, m_ws, l_ws, acc_ws, BH, Sq, Sk,
                               hd, causal, q_offset, kv_len, scale, kw,
                               n_split, stream);
}
