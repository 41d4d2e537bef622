// Chunked SSD scan (Mamba2 state-space duality) for Hopper (sm_90a),
// float32 or bfloat16 data, products on the tensor cores in 3xTF32.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan (Pallas body
// _ssd_kernel), extended to the function the serving path needs, the
// reference's ssd_chunked: an initial state h0 (zero when null) and the
// final state hT as a second output.  For lane b and head h, over chunks of
// L tokens walked in order, with dA = dt * A and seg = cumsum(dA) inside
// the chunk:
//   y[l, p]  = sum_{m <= l} (C_l . B_m) exp(seg_l - seg_m) dt_m x[m, p]
//            + exp(seg_l) sum_n C_l[n] h[p, n]
//   h[p, n] <- h[p, n] exp(seg_end) + sum_l B_l[n] dt_l exp(seg_end - seg_l)
//              x[l, p]
// Shapes: x, y (B, S, H, P); dt (B, S, H); A (H,); Bm, Cm (B, S, N) (one
// SSM group, shared by all heads); h0, hT (B, H, P, N).  Built for P 64
// and N 128 (mamba2) or 64 (zamba2); any chunk length L up to kMaxChunk
// that divides S (plain generation runs whole prompts as one chunk of any
// length).
//
// What bounds it on an H100: at the serving path's short chunks, bytes
// (the 32 KB state of every head is read and written once per call: 5.2 of
// the 6.6 MB of the ssm replay's 32-token chunk); at long chunks,
// operations (per lane, chunk and head P L (L + 1) flops for the masked
// products and 4 L N P for the state's two).
//
// What the design does about it:
//  * Grid (P slice, head, lane), 4 warps a block.  A block owns 16 of its
//    head's 64 state rows (320 blocks at mamba2's 80 heads and one lane,
//    448 at zamba2's 112) and keeps that 16 x N slice in registers, as mma
//    accumulators, across the chunk loop, each of its four warps owning
//    N / 4 state columns (32 at mamba2's N 128, 16 at zamba2's N 64: an
//    H100 sweep timed two warps of 32 columns at N 64 no faster, PERF.md);
//    it is read and written once per call with 16-byte accesses (a
//    quad's fragment pairs are exchanged by shuffles into float4s).
//  * Tensor cores: C.B^T, the masked-decay scores times x, C.h^T and
//    B^T.(dt decay x) are mma.sync.m16n8k8 TF32 products in 3xTF32
//    (csrc/mma_tf32.cuh, shared with B2, B4 and B6) in its accurate form
//    (mma3_acc): each k-step's products summed apart and added to the
//    accumulator by an fp32 add.  The outputs reach 100 and more and the
//    card check allows 1e-4: with mma3's accumulation the 8-token chunk
//    missed it (1.07e-4 on an H100).
//    The exp, the mask and dt stay in fp32 on the CUDA cores.  The score
//    fragment feeds the scores-times-x product as its A operand with no
//    data movement, and the state update takes its tokens in the same
//    permuted order, so every fragment read from shared memory (rows padded
//    to 4 mod 32 floats) is free of bank conflicts.
//  * Tiles of 16 rows and keys, sized to the chunk: a 32-token chunk
//    computes 32 rows, not 64, and a ragged L (200) is masked in the
//    kernel.  Each warp owns one 16-row tile of a group of 4; the block
//    walks the key tiles at or before the group's last row tile, staging
//    each tile's B and x rows by 16-byte cp.async, double-buffered.  Key
//    tiles after a row tile are never visited; inside the diagonal tile
//    the masked pairs (m > l) are an exact 0 without an exp (the reference
//    masks to -1e30 before exp for the same reason: the upper triangle
//    overflows).  The last row group's key walk covers every token of the
//    chunk, and the state update rides on it, each warp over its own
//    N / 4 state columns.
//  * C.B^T is the same for every head.  Above the wrapper's threshold
//    (cb_workspace) a first launch, ssd_cb_kernel, writes its lower
//    triangle for every (lane, chunk) to a workspace of B * n_chunks * Lp^2
//    floats (Lp = L rounded up to 16: 256 KB at 512 tokens in chunks of
//    128, which stays in L2; 256 MiB a lane at one chunk of 8192), and
//    every (head, slice) block reads its score tiles from there; below it
//    each block recomputes its tiles, which costs less than a second
//    launch.
//  * seg is the sequential float32 cumsum of dt * A, one thread per block,
//    with __fmul_rn / __fadd_rn so no FMA contraction changes the rounding:
//    it gives the plain version's bits (a torch.cumsum along a non-inner
//    axis adds in order).  seg reaches about -1400 over a 128-token chunk
//    at A = -16 and exp(seg) underflows to 0 there, as in the reference.
//  * The dynamic shared-memory attribute is set once, at the first call.
//
// bf16 x, B, C and h0 (the launch layer's bf16 steps; the reference's
// all-bf16 kernel case), with dt and A float32 (the wrapper widens them):
// every tile is widened to fp32 as it is staged (plain 8-byte loads in
// place of cp.async), the arithmetic is the float32 kernel's, and y and hT
// are rounded to bf16 once, from fp32, as the Pallas body's astype on
// entry and y.astype(o_ref.dtype) (hT as the reference's ssd_chunked
// returns it).  The state is carried in fp32 across chunks.
//
// Padded lanes (chunk_len 0 in the engine) arrive with dt = 0: nothing
// decays or integrates (exp(0) = 1 and every product added is an exact 0),
// so hT equals h0 bit for bit.  hT is written to its own output, never in
// place into the caller's state.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "page_types.cuh"

namespace {

using repro_mma::cp_async16;
using repro_mma::cp_async_commit;
using repro_mma::cp_async_wait_1;
using repro_mma::cp_async_wait_all;
using repro_mma::load_a;
using repro_mma::mma3_acc;
using repro_mma::p_fragment;
using repro_mma::split;
using repro_page::bf16;
using repro_page::kSmallHalf;
using repro_page::load4;
using repro_page::store4;

constexpr int kP = 64;                   // head_dim the kernel is built for
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 16;                   // rows (and keys) per tile
constexpr int kGroupRows = kWarps * kT;  // rows of one row group
constexpr int kPS = 16;                  // state rows per block
constexpr int kLdX = 32 + 4;             // a staged x row: 4 mod 32 floats
constexpr int kMaxChunk = 8192;

// C, B and state rows of N floats in shared memory: N + 4 floats, 4 mod 32
// at N 64 and 128
template <int N>
__host__ __device__ constexpr int ld_of() { return N + 4; }

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

template <int N>
size_t smem_bytes(int L) {
  constexpr int ld = ld_of<N>();
  const int lp = round16(L);
  const int c_rows = lp < kGroupRows ? lp : kGroupRows;
  return sizeof(float) * ((size_t)c_rows * ld + 2 * kT * ld +
                          2 * kT * kLdX + kPS * ld + 4 * (size_t)lp);
}

// A quad (the 4 lanes t of one fragment row) holds 16 consecutive columns
// as accumulator pairs: lo = columns (2t, 2t + 1), hi = (8 + 2t, 9 + 2t).
// pairs_to_float4 gives lane t the float4 of columns 4t .. 4t + 3;
// float4_to_pairs is its inverse.  Every lane of the warp takes part.
__device__ __forceinline__ float4 pairs_to_float4(float2 lo, float2 hi,
                                                  int t) {
  const int s = ((threadIdx.x & 31) & ~3) + 2 * (t & 1);
  const float a0 = __shfl_sync(0xffffffffu, lo.x, s);
  const float a1 = __shfl_sync(0xffffffffu, lo.y, s);
  const float a2 = __shfl_sync(0xffffffffu, lo.x, s + 1);
  const float a3 = __shfl_sync(0xffffffffu, lo.y, s + 1);
  const float b0 = __shfl_sync(0xffffffffu, hi.x, s);
  const float b1 = __shfl_sync(0xffffffffu, hi.y, s);
  const float b2 = __shfl_sync(0xffffffffu, hi.x, s + 1);
  const float b3 = __shfl_sync(0xffffffffu, hi.y, s + 1);
  return t < 2 ? make_float4(a0, a1, a2, a3) : make_float4(b0, b1, b2, b3);
}

__device__ __forceinline__ void float4_to_pairs(float4 v, int t, float2& lo,
                                                float2& hi) {
  const int base = (threadIdx.x & 31) & ~3;
  const int sl = base + (t >> 1), sh = base + 2 + (t >> 1);
  const float x0 = __shfl_sync(0xffffffffu, v.x, sl);
  const float x1 = __shfl_sync(0xffffffffu, v.y, sl);
  const float x2 = __shfl_sync(0xffffffffu, v.z, sl);
  const float x3 = __shfl_sync(0xffffffffu, v.w, sl);
  const float y0 = __shfl_sync(0xffffffffu, v.x, sh);
  const float y1 = __shfl_sync(0xffffffffu, v.y, sh);
  const float y2 = __shfl_sync(0xffffffffu, v.z, sh);
  const float y3 = __shfl_sync(0xffffffffu, v.w, sh);
  lo = (t & 1) ? make_float2(x2, x3) : make_float2(x0, x1);
  hi = (t & 1) ? make_float2(y2, y3) : make_float2(y0, y1);
}

// 4 elements of T from s into the fp32 shared row at d, zeros when not
// live: a cp.async of 16 bytes in fp32, a plain load widened from bf16
template <typename T>
__device__ __forceinline__ void stage4(float* d, const T* s, bool live) {
  if constexpr (kSmallHalf<T>) {
    cp_async16(d, s, live);
  } else {
    *reinterpret_cast<float4*>(d) =
        live ? load4(s) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// rows [row0, row0 + n_rows) of a (tokens, N) matrix from token tok into
// shared memory rows of N + 4 floats, by nt threads; rows at or past L zeros
template <int N, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long tok, int row0,
                                           int n_rows, int L, int tid,
                                           int nt) {
  for (int e = tid; e < n_rows * (N / 4); e += nt) {
    const int r = e / (N / 4), q = e % (N / 4);
    const bool live = row0 + r < L;
    const T* s = live ? src + (tok + row0 + r) * N + 4 * q : src;
    stage4(dst + r * ld_of<N>() + 4 * q, s, live);
  }
}

// The 16 x 16 tile of C.B^T of one warp: rows from Cw (16 rows of N + 4),
// keys from Bt (16 rows of N + 4); s[j] is the fragment of keys 8j .. 8j + 7.
template <int N>
__device__ __forceinline__ void cb_tile(const float* Cw, const float* Bt,
                                        int g, int t, float (&s)[2][4]) {
  constexpr int ld = ld_of<N>();
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < N; k0 += 8) {
    uint32_t ab[4], as[4];
    load_a(Cw, ld, k0, g, t, ab, as);
    float bf[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bf[j][0] = Bt[(8 * j + g) * ld + k0 + t];
      bf[j][1] = Bt[(8 * j + g) * ld + k0 + t + 4];
    }
    mma3_acc<2>(s, ab, as, bf);
  }
}

// C.B^T per (lane, chunk): block (lane * n_chunks + chunk, row tile r);
// each warp takes key tiles warp, warp + 4, ... up to r (the lower
// triangle) and writes the raw products, rows of Lp floats.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cb, int L) {
  __shared__ __align__(16) float Cs[kT * ld_of<N>()];
  __shared__ __align__(16) float Bs[kWarps][kT * ld_of<N>()];
  const int r = blockIdx.y;
  const long long bc = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lp = round16(L);
  const long long tok = bc * L;          // S = n_chunks * L
  stage_rows<N>(Cs, Cm, tok, kT * r, kT, L, tid, kThreads);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  float* out = cb + (bc * lp + kT * r) * lp;
  for (int kt = warp; kt <= r; kt += kWarps) {
    stage_rows<N>(Bs[warp], Bm, tok, kT * kt, kT, L, lane, 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    float s[2][4];
    cb_tile<N>(Cs, Bs[warp], g, t, s);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = kT * kt + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out + g * lp + m) = make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(out + (g + 8) * lp + m) =
          make_float2(s[j][2], s[j][3]);
    }
    __syncwarp();                        // Bs[warp] is rewritten next
  }
}

// N: the state width; each warp owns N / 4 state columns (a multiple of
// 16: one float4 exchange covers 16 columns)
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const T* __restrict__ h0,
           const float* __restrict__ cb, T* __restrict__ y,
           T* __restrict__ hT, int S, int H, int L) {
  constexpr int NT = kPS / 8;            // 8-column tiles of a y row
  constexpr int kLd = ld_of<N>();
  constexpr int CW = N / kWarps;         // state columns of a warp
  constexpr int NJ = CW / 8;             // its 8-column state tiles
  static_assert(N % kWarps == 0 && CW % 16 == 0,
                "warps own whole 16-column groups of the state");
  extern __shared__ __align__(16) float smem[];
  const int lp = round16(L);
  const int c_rows = min(lp, kGroupRows);
  float* Cs = smem;                      // the row group's C rows
  float* Bs = Cs + c_rows * kLd;         // 2 x one key tile's B rows
  float* Xs = Bs + 2 * kT * kLd;         // 2 x one key tile's x slice
  float* Hs = Xs + 2 * kT * kLdX;        // the state at the chunk's start
  float* seg = Hs + kPS * kLd;
  float* dts = seg + lp;
  float* ey = dts + lp;                  // exp(seg_l)
  float* cw = ey + lp;                   // dt_l exp(seg_end - seg_l)

  const int p0 = blockIdx.x * kPS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nc = S / L, n_t = lp / kT;
  const int n_groups = (n_t + kWarps - 1) / kWarps;
  const long long hbase = ((long long)b * H + h) * kP * N + (long long)p0 * N;
  const float a = A[h];

  // the state slice: hs[j] is the accumulator fragment of rows (g, g + 8)
  // and columns CW warp + 8 j + (2t, 2t + 1)
  float hs[NJ][4];
  // h0 read with 16-byte loads and put into fragment order
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < NJ / 2; ++i) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (h0 != nullptr)
        v = load4(h0 + hbase + (g + 8 * half) * N + CW * warp + 16 * i +
                  4 * t);
      float2 lo, hi;
      float4_to_pairs(v, t, lo, hi);
      hs[2 * i][2 * half] = lo.x;
      hs[2 * i][2 * half + 1] = lo.y;
      hs[2 * i + 1][2 * half] = hi.x;
      hs[2 * i + 1][2 * half + 1] = hi.y;
    }

  for (int c = 0; c < nc; ++c) {
    const long long tok = (long long)b * S + (long long)c * L;
    // one key tile's B rows (where needed) and x slice into buffer kt & 1
    auto stage_tile = [&](int kt, bool need_b) {
      const int buf = kt & 1;
      if (need_b)
        stage_rows<N>(Bs + buf * kT * kLd, Bm, tok, kT * kt, kT, L, tid,
                      kThreads);
      for (int e = tid; e < kT * (kPS / 4); e += kThreads) {
        const int rr = e / (kPS / 4), q = e % (kPS / 4);
        const int l = kT * kt + rr;
        const bool live = l < L;
        const T* s = live ? x + ((tok + l) * H + h) * kP + p0 + 4 * q : x;
        stage4(Xs + buf * kT * kLdX + rr * kLdX + 4 * q, s, live);
      }
    };
    // a row group's C rows and its first key tile, as one cp.async group
    auto stage_group = [&](int rg) {
      stage_rows<N>(Cs, Cm, tok, rg * kGroupRows, c_rows, L, tid, kThreads);
      stage_tile(0, cb == nullptr || rg == n_groups - 1);
      cp_async_commit();
    };
    __syncthreads();                     // the previous chunk is done
    stage_group(0);                      // in flight while seg is formed
    for (int i = tid; i < L; i += kThreads) dts[i] = dt[(tok + i) * H + h];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float* hr = Hs + g * kLd + CW * warp + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(hr) = make_float2(hs[j][0], hs[j][1]);
      *reinterpret_cast<float2*>(hr + 8 * kLd) =
          make_float2(hs[j][2], hs[j][3]);
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
#pragma unroll 8
      for (int i = 0; i < L; ++i) {
        s = __fadd_rn(s, __fmul_rn(dts[i], a));
        seg[i] = s;
      }
    }
    __syncthreads();
    const float seg_end = seg[L - 1];
    for (int i = tid; i < lp; i += kThreads) {
      const bool live = i < L;
      ey[i] = live ? expf(seg[i]) : 0.f;
      cw[i] = live ? dts[i] * expf(seg_end - seg[i]) : 0.f;
    }
    const float e_end = expf(seg_end);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[j][e] *= e_end;

    for (int rg = 0; rg < n_groups; ++rg) {
      const bool last_group = rg == n_groups - 1;
      const bool need_b = cb == nullptr || last_group;
      const int r = rg * kWarps + warp;  // this warp's row tile
      const bool rows = r < n_t;
      const int last_kt = min(rg * kWarps + kWarps - 1, n_t - 1);
      const float* Cw = Cs + warp * kT * kLd;
      __syncthreads();                   // Cs, Bs, Xs free; ey, cw written
      if (rg > 0) stage_group(rg);

      float ya[NT][4], yi[NT][4];        // intra-chunk and incoming-state terms
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[n][e] = yi[n][e] = 0.f;

      for (int kt = 0; kt <= last_kt; ++kt) {
        if (kt < last_kt) {
          stage_tile(kt + 1, need_b);
          cp_async_commit();
          cp_async_wait_1();
        } else {
          cp_async_wait_all();
        }
        __syncthreads();
        const float* Bt = Bs + (kt & 1) * kT * kLd;
        const float* Xt = Xs + (kt & 1) * kT * kLdX;

        if (kt == 0 && rows) {           // C.h^T: the incoming state
#pragma unroll 4
          for (int k0 = 0; k0 < N; k0 += 8) {
            uint32_t ab[4], as[4];
            load_a(Cw, kLd, k0, g, t, ab, as);
            float bf[NT][2];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              bf[n][0] = Hs[(8 * n + g) * kLd + k0 + t];
              bf[n][1] = Hs[(8 * n + g) * kLd + k0 + t + 4];
            }
            mma3_acc<NT>(yi, ab, as, bf);
          }
        }

        if (rows && kt <= r) {           // scores, then scores . x
          float s[2][4];
          if (cb != nullptr) {
            const float* ct = cb + (((long long)b * nc + c) * lp + kT * r) * lp
                              + kT * kt;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float2 v0 = *reinterpret_cast<const float2*>(
                  ct + g * lp + 8 * j + 2 * t);
              const float2 v1 = *reinterpret_cast<const float2*>(
                  ct + (g + 8) * lp + 8 * j + 2 * t);
              s[j][0] = v0.x;
              s[j][1] = v0.y;
              s[j][2] = v1.x;
              s[j][3] = v1.y;
            }
          } else {
            cb_tile<N>(Cw, Bt, g, t, s);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int l = kT * r + g + 8 * (e >> 1);
              const int m = kT * kt + 8 * j + 2 * t + (e & 1);
              s[j][e] = (m <= l && l < L)
                            ? s[j][e] * expf(seg[l] - seg[m]) * dts[m]
                            : 0.f;
            }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t ab[4], as[4];
            p_fragment(s[j][0], s[j][1], s[j][2], s[j][3], ab, as);
            float bf[NT][2];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              bf[n][0] = Xt[(8 * j + 2 * t) * kLdX + 8 * n + g];
              bf[n][1] = Xt[(8 * j + 2 * t + 1) * kLdX + 8 * n + g];
            }
            mma3_acc<NT>(ya, ab, as, bf);
          }
        }

        if (last_group) {                // state += (dt decay x)^T . B
          const float* cwt = cw + kT * kt;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            // tokens in the order 0, 2, 4, 6, 1, 3, 5, 7, as p_fragment
            const int l0 = 8 * ks + 2 * t;
            const float c0 = cwt[l0], c1 = cwt[l0 + 1];
            float bf[NJ][2];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              bf[j][0] = Bt[l0 * kLd + CW * warp + 8 * j + g];
              bf[j][1] = Bt[(l0 + 1) * kLd + CW * warp + 8 * j + g];
            }
            const float* xr = Xt + l0 * kLdX + g;
            uint32_t ab[4], as[4];
            split(xr[0] * c0, ab[0], as[0]);
            split(xr[8] * c0, ab[1], as[1]);
            split(xr[kLdX] * c1, ab[2], as[2]);
            split(xr[kLdX + 8] * c1, ab[3], as[3]);
            mma3_acc<NJ>(hs, ab, as, bf);
          }
        }
        __syncthreads();                 // this tile's buffers are rewritten
      }

      if (rows) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int l = kT * r + g + 8 * half;
          const float e = ey[l];         // 0 past L
#pragma unroll
          for (int i = 0; i < NT / 2; ++i) {
            const float2 lo = make_float2(
                ya[2 * i][2 * half] + e * yi[2 * i][2 * half],
                ya[2 * i][2 * half + 1] + e * yi[2 * i][2 * half + 1]);
            const float2 hi = make_float2(
                ya[2 * i + 1][2 * half] + e * yi[2 * i + 1][2 * half],
                ya[2 * i + 1][2 * half + 1] + e * yi[2 * i + 1][2 * half + 1]);
            const float4 v = pairs_to_float4(lo, hi, t);
            if (l < L)
              store4(y + ((tok + l) * H + h) * kP + p0 + 16 * i + 4 * t, v);
          }
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < NJ / 2; ++i) {
      const float4 v = pairs_to_float4(
          make_float2(hs[2 * i][2 * half], hs[2 * i][2 * half + 1]),
          make_float2(hs[2 * i + 1][2 * half], hs[2 * i + 1][2 * half + 1]), t);
      store4(hT + hbase + (g + 8 * half) * N + CW * warp + 16 * i + 4 * t,
             v);
    }
}

template <typename T, int N>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const T* h0, T* y, T* hT, float* cb, int B, int S,
           int H, int L, cudaStream_t st) {
  if (cb != nullptr) {
    ssd_cb_kernel<T, N><<<dim3((unsigned)((long long)B * (S / L)),
                               round16(L) / kT),
                          kThreads, 0, st>>>(Bm, Cm, cb, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // the attribute is set once per instantiation, to the largest chunk's
  // need (a launch reserves only what it asks for)
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<N>(kMaxChunk));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  ssd_kernel<T, N><<<dim3(kP / kPS, H, B), kThreads, smem_bytes<N>(L), st>>>(
      x, dt, A, Bm, Cm, h0, cb, y, hT, S, H, L);
  return (int)cudaGetLastError();
}

template <typename T>
int ssd_scan(const T* x, const float* dt, const float* A, const T* Bm,
             const T* Cm, const T* h0, T* y, T* hT, float* cb, int B, int S,
             int H, int P, int N, int L, void* stream) {
  if (P != kP || L < 1 || L > kMaxChunk || S % L != 0 || B < 1 ||
      B > 65535 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N == 128)
    return launch<T, 128>(x, dt, A, Bm, Cm, h0, y, hT, cb, B, S, H, L, st);
  if (N == 64)
    return launch<T, 64>(x, dt, A, Bm, Cm, h0, y, hT, cb, B, S, H, L, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// cb: null (every block computes its own C.B^T tiles) or a workspace of
// B * (S / L) * Lp * Lp floats, Lp = L rounded up to 16, which a first
// launch fills.  Returns 0 or the CUDA error of the attribute call or a
// launch; cudaErrorInvalidValue for widths other than P 64 and N 64 or
// 128, a chunk that does not divide S or exceeds kMaxChunk, or a grid the
// card cannot launch.  _f32 takes float32 x, B, C, h0, y and hT; _bf16
// bf16 ones (dt and A float32 in both).
extern "C" int repro_ssd_scan_f32(const float* x, const float* dt,
                                  const float* A, const float* Bm,
                                  const float* Cm, const float* h0, float* y,
                                  float* hT, float* cb, int B, int S, int H,
                                  int P, int N, int L, void* stream) {
  return ssd_scan<float>(x, dt, A, Bm, Cm, h0, y, hT, cb, B, S, H, P, N, L,
                         stream);
}

extern "C" int repro_ssd_scan_bf16(const bf16* x, const float* dt,
                                   const float* A, const bf16* Bm,
                                   const bf16* Cm, const bf16* h0, bf16* y,
                                   bf16* hT, float* cb, int B, int S, int H,
                                   int P, int N, int L, void* stream) {
  return ssd_scan<bf16>(x, dt, A, Bm, Cm, h0, y, hT, cb, B, S, H, P, N, L,
                        stream);
}
