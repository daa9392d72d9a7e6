// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// `ssd_scan_pallas` (body `_ssd_kernel`).  It computes what
// repro_torch.kernels.ssd_scan.ref.ssd_scan_ref computes: with the
// sequence cut into chunks of Q positions and cum the inclusive cumsum
// of dt*A within a chunk, for every (batch, head)
//   y[i]  = sum_{j<=i in chunk} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . state
//   state <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j
// with the state (P x N, float32) carried from chunk to chunk, and
// returns y (in x's dtype) and the final state.  A last chunk shorter
// than Q is the reference's padding with dt = 0: no decay, no input.
//
// What bounds it on the H100: operations.  At the serving shape (B 1,
// S 1,024, H 48, P 64, N 128, Q 256) the four contractions need 2.25
// GFLOP of float32 (C.B^T over the causal pairs 0.03, the causal y 0.81,
// the state update 0.81, y from the carried state 0.60: the state
// entering the first chunk is zero) against 14.9 MB of inputs and
// outputs: 34 us at the float32 rate, 4.4 us of bytes.
//
// Design (simple and right first: float32 FMAs on the CUDA cores, no
// wgmma or TMA yet).  Two grid passes in one call:
//   1. ssd_gram_kernel: G = C B^T of every chunk, once per (batch,
//      chunk), 64 x 64 tiles through shared memory, the lower tiles
//      only; written transposed (gram[j][i]) so that pass 2 reads it
//      coalesced.  1 MB at the serving shape, read back from L2.
//   2. ssd_chunk_kernel: one block per (p-tile of 16 head-dim rows,
//      head, batch) = 192 blocks at the serving shape.  The state rows
//      p are independent (state[h, p, :] depends only on x[:, h, p]), so
//      a block carries only a 16 x N float32 slice of the state (8 KB)
//      in shared memory and walks its chunks in order.  Per chunk: dt,
//      the cumsum (one warp), dt*x for its 16 rows; then a thread per
//      position i accumulates the causal sum over j <= i from gram and
//      exp(cum_i - cum_j), computed on the fly and only for j <= i (so
//      no exp of a positive gap, no inf * 0), then C_i . state from C
//      staged in 32-column tiles; then a thread per state column n
//      updates the block's 16 rows of that column from B staged in
//      64-position tiles (dt*x scaled by exp(cum_last - cum_j) once per
//      chunk).
// The TPU's (Q, Q) and (Q, Q, bH) decay tensors are never formed: at
// Q 256 a float32 (Q, Q) alone is 256 KB, more than a block may hold.
// x, B and C are read through their batch and token strides (the slices
// of ssd_block's conv output), so no copy is made.  Sums are float32
// (fmaf), exponentials are expf, and y is rounded to x's dtype once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define QMAX 1024  // longest chunk the kernel takes
#define NMAX 256   // largest state size the kernel takes (<= kThreads)

namespace {

constexpr int kThreads = 256;
constexpr int kPt = 16;                 // head-dim rows p per block
constexpr int kNT = 32;                 // C columns per y-from-state tile
constexpr int kQT = 64;                 // B positions per state tile
constexpr int kGT = 64;                 // Gram tile (positions)
constexpr int kGN = 32;                 // Gram tile depth (state columns)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);             // round to nearest even, once
}

// floats of dynamic shared memory ssd_chunk_kernel takes for (Q, N)
__host__ __device__ constexpr int smem_floats(int Q, int N) {
  return 3 * ((Q + 3) & ~3) + Q * kPt + N * kPt +
         (kThreads * (kNT + 1) > kQT * N ? kThreads * (kNT + 1) : kQT * N);
}

// gram[b, c, j, i] = sum_n C[b, cQ + i, n] B[b, cQ + j, n] for the 64 x 64
// tiles with j-tile <= i-tile; positions at or past S read as 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_gram_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                float* __restrict__ gram, int S, int N, int Q, int nC,
                long long sbb, long long sbs, long long scb,
                long long scs) {
  const int ti = blockIdx.x, tj = blockIdx.y;
  if (tj > ti) return;                  // above the diagonal: never read
  const int b = blockIdx.z / nC, c = blockIdx.z % nC;
  __shared__ float cs[kGN][kGT + 1];    // +1: conflict-free transposed store
  __shared__ float bs[kGN][kGT + 1];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int i0 = ti * kGT, j0 = tj * kGT, s0 = c * Q;
  const T* cb = Cm + b * scb;
  const T* bb = Bm + b * sbb;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kGN) {
    __syncthreads();
    for (int e = t; e < kGT * kGN; e += kThreads) {
      const int r = e / kGN, nn = e % kGN, n = n0 + nn;
      const int i = i0 + r, j = j0 + r;
      cs[nn][r] = (i < Q && s0 + i < S && n < N)
                      ? to_f32(cb[(long long)(s0 + i) * scs + n]) : 0.f;
      bs[nn][r] = (j < Q && s0 + j < S && n < N)
                      ? to_f32(bb[(long long)(s0 + j) * sbs + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < kGN; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cv[u] = cs[n][tx + 16 * u];
        bv[u] = bs[n][ty + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(cv[u], bv[v], acc[u][v]);
    }
  }
  float* g = gram + (long long)blockIdx.z * Q * Q;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + tx + 16 * u, j = j0 + ty + 16 * v;
      if (i < Q && j < Q) g[(long long)j * Q + i] = acc[u][v];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ gram,
                 T* __restrict__ y, float* __restrict__ state, int S, int H,
                 int P, int N, int Q, int nC, long long sxb, long long sxs,
                 long long sbb, long long sbs, long long scb,
                 long long scs) {
  extern __shared__ float4 smem4[];
  const int Qp = (Q + 3) & ~3;
  float* dts = reinterpret_cast<float*>(smem4);   // [Q] dt of the chunk
  float* cum = dts + Qp;                          // [Q] inclusive cumsum
  float* wend = cum + Qp;                         // [Q] exp(cum_last - cum)
  float* xdt = wend + Qp;                         // [Q][kPt] dt * x
  float* st = xdt + Q * kPt;                      // [N][kPt] carried state
  float* tile = st + N * kPt;                     // C or B rows, staged

  const int t = threadIdx.x;
  const int p0 = blockIdx.x * kPt, h = blockIdx.y, b = blockIdx.z;
  const int np = min(kPt, P - p0);                // live rows of this block
  const float a = A[h];
  const T* xb = x + b * sxb + (long long)h * P + p0;
  const T* bb = Bm + b * sbb;
  const T* cb = Cm + b * scb;
  const float* dtb = dt + (long long)b * S * H + h;

  for (int e = t; e < N * kPt; e += kThreads) st[e] = 0.f;

  for (int c = 0; c < nC; ++c) {
    const int s0 = c * Q;
    const int nv = min(Q, S - s0);                // positions below S
    __syncthreads();                              // last chunk done
    for (int j = t; j < Q; j += kThreads)
      dts[j] = j < nv ? dtb[(long long)(s0 + j) * H] : 0.f;
    __syncthreads();
    if (t < 32) {                                 // cumsum of dt*A, one warp
      float carry = 0.f;
      for (int j0 = 0; j0 < Q; j0 += 32) {
        const int j = j0 + t;
        float v = j < Q ? dts[j] * a : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(kFull, v, off);
          if (t >= off) v += u;
        }
        v += carry;
        if (j < Q) cum[j] = v;
        carry = __shfl_sync(kFull, v, 31);
      }
    }
    for (int e = t; e < Q * kPt; e += kThreads) {
      const int j = e / kPt, p = e % kPt;
      xdt[e] = (j < nv && p < np)
                   ? to_f32(xb[(long long)(s0 + j) * sxs + p]) * dts[j] : 0.f;
    }
    __syncthreads();
    const float clast = cum[Q - 1];               // = cum[nv - 1]: dt 0 after
    for (int j = t; j < Q; j += kThreads) wend[j] = expf(clast - cum[j]);

    // ---- y, a thread per position i
    const float* g = gram + (long long)(b * nC + c) * Q * Q;
    for (int i0 = 0; i0 < nv; i0 += kThreads) {   // uniform: syncs inside
      const int i = i0 + t;
      const bool live = i < nv;
      const float ci = live ? cum[i] : 0.f;
      float acc[kPt], acc2[kPt];
#pragma unroll
      for (int p = 0; p < kPt; ++p) acc[p] = acc2[p] = 0.f;
      if (live) {  // intra-chunk, j <= i: exponent <= 0
        for (int j = 0; j <= i; ++j) {
          const float w = g[(long long)j * Q + i] * expf(ci - cum[j]);
          const float4* xr = reinterpret_cast<const float4*>(xdt + j * kPt);
#pragma unroll
          for (int q = 0; q < kPt / 4; ++q) {
            const float4 v = xr[q];
            acc[4 * q + 0] = fmaf(w, v.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(w, v.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(w, v.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(w, v.w, acc[4 * q + 3]);
          }
        }
      }
      for (int n0 = 0; n0 < N; n0 += kNT) { // C_i . state
        __syncthreads();
        for (int e = t; e < kThreads * kNT; e += kThreads) {
          const int r = e / kNT, nn = e % kNT, n = n0 + nn;
          tile[r * (kNT + 1) + nn] =
              (i0 + r < nv && n < N)
                  ? to_f32(cb[(long long)(s0 + i0 + r) * scs + n]) : 0.f;
        }
        __syncthreads();
        if (live) {
          const int nn = min(kNT, N - n0);
          for (int n = 0; n < nn; ++n) {
            const float cv = tile[t * (kNT + 1) + n];
            const float4* sr =
                reinterpret_cast<const float4*>(st + (n0 + n) * kPt);
#pragma unroll
            for (int q = 0; q < kPt / 4; ++q) {
              const float4 v = sr[q];
              acc2[4 * q + 0] = fmaf(cv, v.x, acc2[4 * q + 0]);
              acc2[4 * q + 1] = fmaf(cv, v.y, acc2[4 * q + 1]);
              acc2[4 * q + 2] = fmaf(cv, v.z, acc2[4 * q + 2]);
              acc2[4 * q + 3] = fmaf(cv, v.w, acc2[4 * q + 3]);
            }
          }
        }
      }
      if (live) {
        const float ei = expf(ci);
        T* yr = y + (((long long)b * S + s0 + i) * H + h) * P + p0;
#pragma unroll
        for (int p = 0; p < kPt; ++p)
          if (p < np) store(yr + p, fmaf(ei, acc2[p], acc[p]));
      }
    }

    // ---- state <- exp(cum_last) state + sum_j B_j (wend_j dt_j x_j).
    // dt*x is dead after y: once every thread is past its y reads, fold
    // wend into it, then a thread per state column n (N <= kThreads)
    // carries the block's kPt rows of that column.
    __syncthreads();
    for (int e = t; e < nv * kPt; e += kThreads) xdt[e] *= wend[e / kPt];
    const bool own = t < N;
    float sacc[kPt];
    if (own) {
      const float dend = expf(clast);
      const float4* sr = reinterpret_cast<const float4*>(st + t * kPt);
#pragma unroll
      for (int q = 0; q < kPt / 4; ++q) {
        const float4 v = sr[q];
        sacc[4 * q + 0] = dend * v.x;
        sacc[4 * q + 1] = dend * v.y;
        sacc[4 * q + 2] = dend * v.z;
        sacc[4 * q + 3] = dend * v.w;
      }
    }
    for (int j0 = 0; j0 < nv; j0 += kQT) {
      __syncthreads();
      for (int e = t; e < kQT * N; e += kThreads) {
        const int r = e / N, n = e % N;
        tile[e] = j0 + r < nv
                      ? to_f32(bb[(long long)(s0 + j0 + r) * sbs + n]) : 0.f;
      }
      __syncthreads();
      if (own) {
        const int jn = min(kQT, nv - j0);
        for (int r = 0; r < jn; ++r) {
          const float bv = tile[r * N + t];
          const float4* ur =
              reinterpret_cast<const float4*>(xdt + (j0 + r) * kPt);
#pragma unroll
          for (int q = 0; q < kPt / 4; ++q) {
            const float4 v = ur[q];
            sacc[4 * q + 0] = fmaf(bv, v.x, sacc[4 * q + 0]);
            sacc[4 * q + 1] = fmaf(bv, v.y, sacc[4 * q + 1]);
            sacc[4 * q + 2] = fmaf(bv, v.z, sacc[4 * q + 2]);
            sacc[4 * q + 3] = fmaf(bv, v.w, sacc[4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();                              // every read of st done
    if (own) {
      float4* sw = reinterpret_cast<float4*>(st + t * kPt);
#pragma unroll
      for (int q = 0; q < kPt / 4; ++q)
        sw[q] = make_float4(sacc[4 * q + 0], sacc[4 * q + 1],
                            sacc[4 * q + 2], sacc[4 * q + 3]);
    }
  }
  __syncthreads();
  float* sb = state + (((long long)b * H + h) * P + p0) * N;
  for (int e = t; e < kPt * N; e += kThreads) {
    const int pp = e / N, n = e % N;
    if (pp < np) sb[(long long)pp * N + n] = st[n * kPt + pp];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, float* gram, int B,
           int S, int H, int P, int N, int Q, long long sxb, long long sxs,
           long long sbb, long long sbs, long long scb, long long scs,
           cudaStream_t st) {
  const int nC = (S + Q - 1) / Q;
  const int nt = (Q + kGT - 1) / kGT;
  if ((long long)B * nC > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  ssd_gram_kernel<T><<<dim3(nt, nt, B * nC), kThreads, 0, st>>>(
      (const T*)Bm, (const T*)Cm, gram, S, N, Q, nC, sbb, sbs, scb, scs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static bool opted_in = false;                   // once per instantiation
  if (!opted_in) {
    err = cudaFuncSetAttribute(ssd_chunk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_floats(QMAX, NMAX) * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const size_t smem = (size_t)smem_floats(Q, N) * sizeof(float);
  ssd_chunk_kernel<T><<<dim3((P + kPt - 1) / kPt, H, B), kThreads, smem,
                        st>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, gram, (T*)y, state, S,
      H, P, N, Q, nC, sxb, sxs, sbb, sbs, scb, scs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_qmax() { return QMAX; }
extern "C" int ssd_scan_nmax() { return NMAX; }

// dtype: 0 = float32 x/Bm/Cm/y, 1 = bfloat16.  dt, A, state and gram are
// float32; gram is (B, ceil(S/Q), Q, Q) scratch.  Strides are in
// elements.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, void* gram, int dtype, int B,
                               int S, int H, int P, int N, int Q,
                               long long sxb, long long sxs, long long sbb,
                               long long sbs, long long scb, long long scs,
                               void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || N > NMAX || Q < 1 ||
      Q > QMAX || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, (const float*)dt, (const float*)A, Bm, Cm, y,
                         (float*)state, (float*)gram, B, S, H, P, N, Q, sxb,
                         sxs, sbb, sbs, scb, scs, st);
  return launch<__nv_bfloat16>(x, (const float*)dt, (const float*)A, Bm, Cm,
                               y, (float*)state, (float*)gram, B, S, H, P, N,
                               Q, sxb, sxs, sbb, sbs, scb, scs, st);
}
