// Dense flash attention for Hopper (sm_90a), float32.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bh
// (Pallas body _flash_kernel).  Heads are pre-flattened and GQA
// pre-expanded by the caller: q (BH, Sq, hd), k/v (BH, Sk, hd), out
// (BH, Sq, hd).  Key j is visible to query row i iff j < kv_len and, when
// causal, j <= q_offset + i.  Masked scores are NEG_INF = -1e30, the
// softmax denominator is floored at 1e-30, accumulation is float32, as in
// the TPU kernel.  Sq and Sk need not be multiples of any tile (whisper's
// encoder has 1500 frames); the TPU wrapper pads to 128-row blocks, this
// kernel masks the ragged edge itself.
//
// What bounds it on an H100: operations at the encoder's shape (Sq = Sk =
// 1500, hd 64: 4 hd flops per visible (row, key) pair, 576 flops a byte
// of q/k/v/out), bytes at a cross-attention decode step (Sq 1: every key
// and value is read once for one row).
//
// The design: one 128-thread block per (bh, query tile of 4R rows); each
// of the 4 warps owns R rows.  Key tiles of 64 keys are staged in shared
// memory (K with a padded row stride so that 32 lanes reading 32 keys at
// one depth hit 32 banks); each lane scores 2 keys for all R rows, reading
// the queries as broadcasts, then the warp runs the online softmax of its
// rows (max by shuffles; the denominator is kept per lane and summed once
// at the end, since every lane rescales by the same factor), writes the
// tile's probabilities to shared memory and accumulates P.V with each lane
// owning hd / 32 output columns.  R is 16 for long query blocks (64 rows),
// 4 for prefill chunks of 16 to 63 rows, 1 for decode.  With causal
// masking, key tiles past the block's last visible key are skipped; keys
// past the tile's last live key are not accumulated (their probability is
// exactly 0, so the sum is the same).  CUDA cores only: no tensor cores,
// no library call.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 64;

template <int HD, int R>
constexpr size_t smem_floats() {
  // q tile, K tile (padded), V tile, per-warp probabilities
  return (size_t)kWarps * R * HD + (size_t)kBlockK * (HD + 1) +
         (size_t)kBlockK * HD + (size_t)kWarps * R * kBlockK;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD, int R>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q,    // (BH, Sq, HD)
    const float* __restrict__ k,    // (BH, Sk, HD)
    const float* __restrict__ v,    // (BH, Sk, HD)
    float* __restrict__ out,        // (BH, Sq, HD)
    int Sq, int Sk, int causal, int q_offset, int kv_len, float scale) {
  constexpr int BQ = kWarps * R;
  constexpr int KS = HD + 1;      // padded K row stride
  constexpr int DPL = HD / 32;    // output columns per lane

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // BQ * HD
  float* k_s = q_s + BQ * HD;                     // kBlockK * KS
  float* v_s = k_s + kBlockK * KS;                // kBlockK * HD
  float* p_s = v_s + kBlockK * HD;                // BQ * kBlockK

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const float* qb = q + bh * Sq * HD;
  const float* kb = k + bh * Sk * HD;
  const float* vb = v + bh * Sk * HD;
  float* ob = out + bh * Sq * HD;

  // the query tile, rows past Sq as zeros
  for (int e = tid * 4; e < BQ * HD; e += kThreads * 4) {
    const int r = e / HD, d = e - r * HD;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq)
      val = *reinterpret_cast<const float4*>(qb + (long long)(q0 + r) * HD +
                                             d);
    *reinterpret_cast<float4*>(q_s + e) = val;
  }

  // keys any row of this block may see: [0, n_keys)
  int n_keys = kv_len < Sk ? kv_len : Sk;
  const int last_row = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  if (causal && q_offset + last_row + 1 < n_keys)
    n_keys = q_offset + last_row + 1;

  // per row: keys j < lim are visible
  int lim[R];
  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + warp * R + r;
    int lr = kv_len < Sk ? kv_len : Sk;
    if (causal && q_offset + row + 1 < lr) lr = q_offset + row + 1;
    lim[r] = lr;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const float* qw = q_s + warp * R * HD;
  float* pw = p_s + warp * R * kBlockK;

  for (int k0 = 0; k0 < n_keys; k0 += kBlockK) {
    const int live = (n_keys - k0 < kBlockK) ? n_keys - k0 : kBlockK;
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int e = tid * 4; e < kBlockK * HD; e += kThreads * 4) {
      const int p = e / HD, d = e - p * HD;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (p < live) {
        const long long off = (long long)(k0 + p) * HD + d;
        kv = *reinterpret_cast<const float4*>(kb + off);
        vv = *reinterpret_cast<const float4*>(vb + off);
      }
      float* kr = k_s + p * KS + d;
      kr[0] = kv.x;
      kr[1] = kv.y;
      kr[2] = kv.z;
      kr[3] = kv.w;
      *reinterpret_cast<float4*>(v_s + e) = vv;
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 for the warp's R rows
    float s0[R], s1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s0[r] = s1[r] = 0.f;
    const float* k0r = k_s + lane * KS;
    const float* k1r = k_s + (lane + 32) * KS;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float ka[4], kc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ka[c] = k0r[d + c];
        kc[c] = k1r[d + c];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qd = *reinterpret_cast<const float4*>(qw + r * HD + d);
        s0[r] += qd.x * ka[0] + qd.y * ka[1] + qd.z * ka[2] + qd.w * ka[3];
        s1[r] += qd.x * kc[0] + qd.y * kc[1] + qd.z * kc[2] + qd.w * kc[3];
      }
    }

    // online softmax of each row over this tile
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j0 = k0 + lane, j1 = k0 + lane + 32;
      const float a0 = j0 < lim[r] ? s0[r] * scale : kNegInf;
      const float a1 = j1 < lim[r] ? s1[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(a0, a1)));
      const float alpha = expf(m[r] - m_new);
      const float p0 = expf(a0 - m_new), p1 = expf(a1 - m_new);
      l[r] = l[r] * alpha + (p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      pw[r * kBlockK + lane] = p0;
      pw[r * kBlockK + lane + 32] = p1;
    }
    __syncwarp();
    for (int j = 0; j < live; ++j) {
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vv[i] = v_s[j * HD + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = pw[r * kBlockK + j];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] += p * vv[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lsum = warp_sum(l[r]);
    const int row = q0 + warp * R + r;
    if (row < Sq) {
      const float den = fmaxf(lsum, 1e-30f);
      float* orow = ob + (long long)row * HD;
#pragma unroll
      for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = acc[r][i] / den;
    }
  }
}

template <int HD, int R>
int launch(const float* q, const float* k, const float* v, float* out,
           int BH, int Sq, int Sk, int causal, int q_offset, int kv_len,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD, R>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr int BQ = kWarps * R;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_attention_kernel<HD, R><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, Sq, Sk, causal, q_offset, kv_len, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_rows(const float* q, const float* k, const float* v, float* out,
                int BH, int Sq, int Sk, int causal, int q_offset, int kv_len,
                float scale, cudaStream_t stream) {
  if (Sq >= 64)
    return launch<HD, 16>(q, k, v, out, BH, Sq, Sk, causal, q_offset, kv_len,
                          scale, stream);
  if (Sq >= 16)
    return launch<HD, 4>(q, k, v, out, BH, Sq, Sk, causal, q_offset, kv_len,
                         scale, stream);
  return launch<HD, 1>(q, k, v, out, BH, Sq, Sk, causal, q_offset, kv_len,
                       scale, stream);
}

}  // namespace

// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for a head
// dim other than 32, 64 or 128 or a grid the card cannot launch.
extern "C" int repro_flash_attention_f32(
    const float* q, const float* k, const float* v, float* out, int BH,
    int Sq, int Sk, int hd, int causal, int q_offset, int kv_len,
    float scale, void* stream) {
  if (BH <= 0 || Sq <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_rows<32>(q, k, v, out, BH, Sq, Sk, causal, q_offset,
                             kv_len, scale, s);
    case 64:
      return launch_rows<64>(q, k, v, out, BH, Sq, Sk, causal, q_offset,
                             kv_len, scale, s);
    case 128:
      return launch_rows<128>(q, k, v, out, BH, Sq, Sk, causal, q_offset,
                              kv_len, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
