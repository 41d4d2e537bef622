// Chunked SSD scan (Mamba2 state-space duality) for Hopper (sm_90a),
// float32.
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
// SSM group, shared by all heads); h0, hT (B, H, P, N).  Built for
// mamba2's P 64 and N 128; any chunk length L up to kMaxChunk that divides
// S (plain generation runs whole prompts as one chunk of any length).
//
// What bounds it on an H100: per lane, chunk and head the two quadratic
// products cost P * L (L + 1) flops and the state's two products 4 L N P,
// against 4 (2 H P + H) bytes per token, so it is bound by operations
// (float32 FMAs outside the tensor cores in this version; 67 TFLOP/s).
//
// What the design does about it:
//  * One block per (head, lane), 256 threads; the chunks are walked in
//    order inside the block (the TPU kernel's sequential grid axis), and
//    the state h (P x N = 32 KB) stays in shared memory across chunks.
//  * Within a chunk, rows and keys are walked in tiles of 64, so no L x L
//    buffer exists and any L works.  For each row tile the block stages its
//    C rows; for each key tile at or before it, the B and x rows; the
//    scores C . B, decayed and scaled by dt, go to shared memory, then are
//    multiplied into x.  Key tiles after the row tile are never visited,
//    and inside the diagonal tile the masked pairs (m > l) are set to an
//    exact 0 without computing their exp (the reference masks to -1e30
//    before exp for the same reason: the upper triangle overflows).
//  * Every product is a 64 x 64 (or 128 x 64) tile computed by 16 x 16
//    threads with a 4 x 4 (or 8 x 4) register tile, its operands stored
//    k-major in shared memory (padded rows) so each step reads float4s.
//  * seg is the sequential float32 cumsum of dt * A, one thread per block,
//    with __fmul_rn / __fadd_rn so no FMA contraction changes the rounding:
//    it gives the plain version's bits (a torch.cumsum along a non-inner
//    axis adds in order).  seg reaches about -1400 over a 128-token chunk
//    at A = -16 and exp(seg) underflows to 0 there, as in the reference.
//  * C . B is recomputed by every head's block (it is the same for all);
//    sharing it, tensor cores (wgmma) and TMA are later work.
//
// Padded lanes (chunk_len 0 in the engine) arrive with dt = 0: nothing
// decays or integrates, so hT equals h0.  hT is written to its own output,
// never in place into the caller's state.
#include <cuda_runtime.h>

namespace {

constexpr int kP = 64;                   // head_dim the kernel is built for
constexpr int kN = 128;                  // d_state
constexpr int kT = 64;                   // rows (and keys) per tile
constexpr int kThreads = 256;            // 16 x 16
constexpr int kLd = kT + 4;              // padded row of a k-major tile
constexpr int kLdB = kN + 4;             // padded row of the B rows (state)
constexpr int kMaxChunk = 8192;
static_assert(kP == kT, "the x tile and the y tile share one layout");
static_assert(kT * kLdB <= kN * kLd, "B rows reuse the B^T buffer");

// shared-memory floats before the seg / dt arrays
constexpr int kCt = kN * kLd;            // C rows, n-major: Ct[n][l]
constexpr int kBt = kN * kLd;            // B rows, n-major / row-major
constexpr int kSt = kT * kLd;            // scores, key-major: St[m][l]
constexpr int kXs = kT * kLd;            // x rows (or weighted x): Xs[m][p]
constexpr int kHt = kN * kLd;            // state, n-major: Ht[n][p]
constexpr int kFixed = kCt + kBt + kSt + kXs + kHt;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ hT, int S, int H,
           int L) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;
  float* Bt = Ct + kCt;
  float* St = Bt + kBt;
  float* Xs = St + kSt;
  float* Ht = Xs + kXs;
  float* seg = Ht + kHt;
  float* dts = seg + L;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long tok0 = (long long)b * S;          // first token of lane b
  const long long hp = ((long long)b * H + h) * kP * kN;

  for (int i = tid; i < kP * kN; i += kThreads) {
    const int p = i / kN, n = i % kN;
    Ht[n * kLd + p] = h0 != nullptr ? h0[hp + i] : 0.f;
  }
  const float a = A[h];

  for (int c0 = 0; c0 < S; c0 += L) {
    for (int i = tid; i < L; i += kThreads)
      dts[i] = dt[(tok0 + c0 + i) * H + h];
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < L; ++i) {
        s = __fadd_rn(s, __fmul_rn(dts[i], a));
        seg[i] = s;
      }
    }
    __syncthreads();
    const float seg_end = seg[L - 1];

    // ---------------- outputs, one row tile at a time ----------------
    for (int l0 = 0; l0 < L; l0 += kT) {
      const int nl = min(kT, L - l0);
      for (int i = tid; i < kT * kN; i += kThreads) {
        const int r = i / kN, n = i % kN;
        Ct[n * kLd + r] = r < nl ? Cm[(tok0 + c0 + l0 + r) * kN + n] : 0.f;
      }
      float acc[4][4] = {};
      for (int m0 = 0; m0 <= l0; m0 += kT) {
        const int nm = min(kT, L - m0);
        for (int i = tid; i < kT * kN; i += kThreads) {
          const int r = i / kN, n = i % kN;
          Bt[n * kLd + r] = r < nm ? Bm[(tok0 + c0 + m0 + r) * kN + n] : 0.f;
        }
        for (int i = tid; i < kT * kP; i += kThreads) {
          const int r = i / kP, p = i % kP;
          Xs[r * kLd + p] =
              r < nm ? x[((tok0 + c0 + m0 + r) * H + h) * kP + p] : 0.f;
        }
        __syncthreads();
        // scores s[i][j] = C_l . B_m, rows l = 4 ty + i, keys m = 4 tx + j
        float s[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < kN; ++n) {
          const float4 c4 = ld4(Ct + n * kLd + 4 * ty);
          const float4 b4 = ld4(Bt + n * kLd + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              s[i][j] = fmaf(at(c4, i), at(b4, j), s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int lr = 4 * ty + i, mr = 4 * tx + j;
            const int l = l0 + lr, m = m0 + mr;
            float v = 0.f;
            if (m <= l && lr < nl && mr < nm)
              v = s[i][j] * expf(seg[l] - seg[m]) * dts[m];
            St[mr * kLd + lr] = v;
          }
        }
        __syncthreads();
        // acc[l][p] += sum_m St[m][l] x[m][p], rows 4 ty + i, p = 4 tx + j
#pragma unroll 4
        for (int m = 0; m < kT; ++m) {
          const float4 s4 = ld4(St + m * kLd + 4 * ty);
          const float4 x4 = ld4(Xs + m * kLd + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(at(s4, i), at(x4, j), acc[i][j]);
        }
        __syncthreads();   // Bt, Xs and St are rewritten by the next tile
      }
      // the incoming state: exp(seg_l) sum_n C_l[n] h[p][n]
      float q[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < kN; ++n) {
        const float4 c4 = ld4(Ct + n * kLd + 4 * ty);
        const float4 h4 = ld4(Ht + n * kLd + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            q[i][j] = fmaf(at(c4, i), at(h4, j), q[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lr = 4 * ty + i;
        if (lr >= nl) continue;
        const float e = expf(seg[l0 + lr]);
        float4 o;
        o.x = acc[i][0] + e * q[i][0];
        o.y = acc[i][1] + e * q[i][1];
        o.z = acc[i][2] + e * q[i][2];
        o.w = acc[i][3] + e * q[i][3];
        *reinterpret_cast<float4*>(
            y + ((tok0 + c0 + l0 + lr) * H + h) * kP + 4 * tx) = o;
      }
      __syncthreads();     // Ct is rewritten by the next row tile
    }

    // ------------- state: h <- h exp(seg_end) + B^T (w x) --------------
    // thread (ty, tx) owns rows n = ty + 16 k (k < 8) and p = 4 tx + j
    const float e_end = expf(seg_end);
    float hn[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 h4 = ld4(Ht + (ty + 16 * k) * kLd + 4 * tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) hn[k][j] = at(h4, j) * e_end;
    }
    for (int l0 = 0; l0 < L; l0 += kT) {
      const int nl = min(kT, L - l0);
      for (int i = tid; i < kT * kN; i += kThreads) {
        const int r = i / kN, n = i % kN;
        Bt[r * kLdB + n] = r < nl ? Bm[(tok0 + c0 + l0 + r) * kN + n] : 0.f;
      }
      for (int i = tid; i < kT * kP; i += kThreads) {
        const int r = i / kP, p = i % kP;
        float w = 0.f;
        if (r < nl) {
          const int l = l0 + r;
          w = x[((tok0 + c0 + l) * H + h) * kP + p] *
              (dts[l] * expf(seg_end - seg[l]));
        }
        Xs[r * kLd + p] = w;
      }
      __syncthreads();
#pragma unroll 4
      for (int l = 0; l < kT; ++l) {
        const float4 w4 = ld4(Xs + l * kLd + 4 * tx);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float bv = Bt[l * kLdB + ty + 16 * k];
#pragma unroll
          for (int j = 0; j < 4; ++j) hn[k][j] = fmaf(bv, at(w4, j), hn[k][j]);
        }
      }
      __syncthreads();     // Bt and Xs are rewritten by the next tile
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float4 o;
      o.x = hn[k][0];
      o.y = hn[k][1];
      o.z = hn[k][2];
      o.w = hn[k][3];
      *reinterpret_cast<float4*>(Ht + (ty + 16 * k) * kLd + 4 * tx) = o;
    }
    __syncthreads();       // Ht is read by the next chunk; dts rewritten
  }

  for (int i = tid; i < kP * kN; i += kThreads) {
    const int p = i / kN, n = i % kN;
    hT[hp + i] = Ht[n * kLd + p];
  }
}

}  // namespace

// Returns 0 or the CUDA error of the attribute call or the launch.
extern "C" int repro_ssd_scan_f32(const float* x, const float* dt,
                                  const float* A, const float* Bm,
                                  const float* Cm, const float* h0, float* y,
                                  float* hT, int B, int S, int H, int P,
                                  int N, int L, void* stream) {
  if (P != kP || N != kN || L < 1 || L > kMaxChunk || S % L != 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)(kFixed + 2 * L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      x, dt, A, Bm, Cm, h0, y, hT, S, H, L);
  return (int)cudaGetLastError();
}
