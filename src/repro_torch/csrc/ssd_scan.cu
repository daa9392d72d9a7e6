// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a), and its backward
// (at "backward" below).
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
// What bounds it on the H100: bytes, once the contractions run on the
// tensor cores.  At the serving shape (B 1, S 1,024, H 48, P 64, N 128,
// Q 256) the contractions need 2.25 GFLOP (2.3 us at the bf16 rate)
// against 14.9 MB of inputs and outputs (4.4 us at 3.35 TB/s).
//
// Design: Mamba2's own chunked decomposition, parallel over (batch,
// chunk, head), in three grid passes of one call:
//   1. ssd_chunk_state_kernel, a block per (64 x 64 tile of the state,
//      head, batch x chunk) (384 blocks at the serving shape): the
//      chunk's own state (x o dt o exp(cum_last - cum))^T . B, a
//      (P x Q).(Q x N) product in 64-position steps, into float32 scratch
//      (B, nC, H, P, N) (6.3 MB at the serving shape; it stays in L2),
//      and cum_last of each (batch, chunk, head).
//   2. ssd_state_pass_kernel, a thread per state element of each (batch,
//      head): walks the chunks in order, S_c = exp(cum_last_{c-1})
//      S_{c-1} + local_{c-1}, overwrites the scratch with the state
//      entering each chunk and writes the final state.
//   3. ssd_chunk_scan_kernel, a block per (64 positions i x 64 head-dim
//      rows, head, batch x chunk) (768 blocks at the serving shape):
//      y = exp(cum_i) C_i . S_c^T (skipped in chunk 0, whose entering
//      state is zero), then for each 64-position tile j at or below i:
//      G = C . B^T, W = G o exp(cum_i - cum_j) o dt_j (formed only for
//      j <= i: no exp of a positive gap, no inf * 0), y += W . x.  C_i
//      stays in shared memory over the whole state size; each tile j is
//      one staging step (B_j and x_j), so a block waits on memory
//      (ceil(i/64) + 2) times, not once per 32 x 32 sub-tile.
// Every product is mma.sync m16n8k16 (bf16 in, float32 accumulate) on
// 16-row warp tiles, staged through shared memory with both operands
// contiguous along the reduced axis (16-byte loads where the inputs'
// strides allow, four in flight a thread).  For bfloat16 inputs the
// operands the kernel forms in float32 (W, the carried state) are
// rounded to bfloat16 for the product, as the TPU's MXU does with
// default precision; x o dt o decay is split into a bfloat16 head and
// remainder (two products, hi . B + lo . B), because the final state it
// makes is held to 3e-4 and one rounding would put its largest error
// near that.  For float32 inputs the same tiles run as float32 FMAs on
// the CUDA cores (the reference's 3e-4 tolerance rules out single-pass
// TF32).  Tiles are padded with zeros in shared memory, so any S,
// Q <= 1,024, N <= 256, any P and the reduced widths (Q, N, P 16) run
// here.  x, B and C are read through their batch and token strides (the
// slices of ssd_block's conv output), so no copy is made.  Passes 1 and
// 2 use static shared memory under 48 KB; pass 3 sizes its own from Q
// and N (55 KB at the serving shape) after opting in once per device.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define QMAX 1024  // longest chunk the kernel takes
#define NMAX 256   // largest state size the kernel takes

namespace {

constexpr int kThreads = 128;           // 4 warps, 16 output rows each
constexpr int kTile = 64;               // output rows / columns a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return __float2bfloat16(v);         // round to nearest even, once
  }
}

// Padding of a staged tile's rows: 16 bytes, so that a row is a whole
// number of 16-byte vectors and, with the row length a multiple of 16
// elements, the fragment loads of a warp hit 32 distinct banks.
template <typename T>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] += A[16 x k] . B[8 x k]^T over k < KT (a multiple of 16) for
// the warp's 16 rows m of A and the 8-row tiles nt of B.  A is stored
// [m][k] (AT false: As points at the warp's first row) or [k][m] (AT
// true: As points at the warp's first column); B is stored [n][k] or,
// BT, [k][n]; lda / ldb are the stored row lengths.  A stored row of k
// is read as 32-bit pairs, a stored row of m or n through ldmatrix.trans.
// acc[nt] holds the m16n8 fragment: rows g, g + 8, columns 2 t, 2 t + 1.
template <typename T, int NT, bool AT, bool BT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const T* __restrict__ As, int lda,
                                         const T* __restrict__ Bs, int ldb,
                                         int KT) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    const int mi = lane >> 3, r = lane & 7;   // ldmatrix: matrix, row
    static_assert(!BT || NT % 2 == 0, "ldmatrix loads n-tiles in pairs");
    for (int k0 = 0; k0 < KT; k0 += 16) {
      uint32_t a[4];
      if constexpr (AT) {
        ldsm_x4_trans(As + (k0 + (mi >> 1) * 8 + r) * lda + (mi & 1) * 8,
                      a[0], a[1], a[2], a[3]);
      } else {
        const T* ar = As + g * lda + k0 + 2 * t;
        a[0] = *reinterpret_cast<const uint32_t*>(ar);
        a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * lda);
        a[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * lda + 8);
      }
      if constexpr (BT) {
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t b[4];
          ldsm_x4_trans(
              Bs + (k0 + (mi & 1) * 8 + r) * ldb + (nt + (mi >> 1)) * 8,
              b[0], b[1], b[2], b[3]);
          mma_bf16(acc[nt], a, b[0], b[1]);
          mma_bf16(acc[nt + 1], a, b[2], b[3]);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const T* br = Bs + (nt * 8 + g) * ldb + k0 + 2 * t;
          mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(br),
                   *reinterpret_cast<const uint32_t*>(br + 8));
        }
      }
    }
  } else {                              // float32: the same tile as FMAs
    auto A_ = [&](int m, int k) {
      return AT ? As[k * lda + m] : As[m * lda + k];
    };
    auto B_ = [&](int n, int k) {
      return BT ? Bs[k * ldb + n] : Bs[n * ldb + k];
    };
    for (int k = 0; k < KT; ++k) {
      const float a0 = A_(g, k), a1 = A_(g + 8, k);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = B_(nt * 8 + 2 * t, k);
        const float b1 = B_(nt * 8 + 2 * t + 1, k);
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  }
}

// 16 bytes of Ts, its first `valid` elements from p (the rest zero):
// one 16-byte load when `vec` and all are valid.
template <typename Ts>
__device__ __forceinline__ uint4 fetch16(const Ts* p, int valid, bool vec) {
  constexpr int VEC = 16 / (int)sizeof(Ts);
  if (vec && valid == VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 u = make_uint4(0, 0, 0, 0);
  Ts* e = reinterpret_cast<Ts*>(&u);
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (j < valid) e[j] = p[j];
  return u;
}

// float32 values of a 16-byte chunk of Ts.
template <typename Ts>
__device__ __forceinline__ void widen(uint4 u, float* v) {
  if constexpr (sizeof(Ts) == 4) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// n float32 values as T, stored at dst (16-byte aligned for n * size).
template <typename T, int n>
__device__ __forceinline__ void store_as(T* dst, const float* v) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < n; j += 4)
      *reinterpret_cast<float4*>(dst + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
    uint32_t w[n / 2];
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (n == 8)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// Two float32 values as T at dst (aligned for two T).
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  }
}

// Reads the tile src[r * lds + k] for r < rows, k < cols (cols a multiple
// of 16 bytes of Ts; zero at or past nrow or ncol) in 16-byte chunks and
// hands each to put(r, k, chunk), which stores it in shared memory.
// 16-byte loads when `vec` (src and lds 16-byte aligned), four chunks in
// flight a thread.
template <typename Ts, typename F>
__device__ __forceinline__ void stage(const Ts* __restrict__ src,
                                      long long lds, int rows, int cols,
                                      int nrow, int ncol, bool vec, F put) {
  constexpr int VEC = 16 / (int)sizeof(Ts);
  constexpr int U = 4;
  const int per_row = cols / VEC, total = rows * per_row;
  for (int e0 = threadIdx.x; e0 < total; e0 += U * kThreads) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / per_row, k = (e - r * per_row) * VEC;
      const int valid = e < total && r < nrow ? min(VEC, max(0, ncol - k)) : 0;
      v[u] = fetch16(src + r * lds + k, valid, vec);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads;
      if (e < total) {
        const int r = e / per_row;
        put(r, (e - r * per_row) * VEC, v[u]);
      }
    }
  }
}

// dts[j] = dt of position s0 + j (0 at or past nv) and cum[j] the
// inclusive cumsum of dt * a, for j < Q (<= 1,024): each thread sums its
// run of ceil(Q / 128) positions, the block scans the runs' totals.
// Ends with a block barrier.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dtb,
                                             int H, int s0, int nv, int Q,
                                             float a, float* dts,
                                             float* cum) {
  __shared__ float warp_total[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int m = (Q + kThreads - 1) / kThreads, j0 = t * m;
  float run[QMAX / kThreads], d[QMAX / kThreads];
  float total = 0.f;
#pragma unroll
  for (int u = 0; u < QMAX / kThreads; ++u) {
    const int j = j0 + u;
    d[u] = u < m && j < nv ? dtb[(long long)(s0 + j) * H] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < QMAX / kThreads; ++u) {
    total += d[u] * a;
    run[u] = total;
  }
  float incl = total;                   // scan of the runs in the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  float offset = incl - total;
  for (int w = 0; w < warp; ++w) offset += warp_total[w];
#pragma unroll
  for (int u = 0; u < QMAX / kThreads; ++u) {
    const int j = j0 + u;
    if (u < m && j < Q) {
      dts[j] = d[u];
      cum[j] = run[u] + offset;
    }
  }
  __syncthreads();
}

struct Strides {                        // in elements
  long long xb, xs, bb, bs, cb, cs;
  int vx, vb, vc, vy;                   // 16-byte accesses allowed
};

// Pass 1.  Grid (ceil(P/64) * ceil(N/64), H, B * nC).  With kGrad it is
// the backward's pass 1': x is gy, Bm is C and the weight of position j
// is exp(cum_j), so each chunk c > 0 gets D_c = (gy o exp(cum))^T . C, its
// own part of the gradient of the state entering it (chunk 0's entering
// state is zero: no block, no write).
template <typename T, bool kGrad = false>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ cdecay,
                       int S, int H, int P, int N, int Q, int nC, Strides sd) {
  constexpr int LD = kTile + pad<T>();
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr bool kSplit = sizeof(T) == 2;      // x dt decay as hi + lo
  __shared__ float dts[QMAX], cum[QMAX];
  __shared__ __align__(16) T xs[kTile * LD];   // [j][p]: x dt decay
  __shared__ __align__(16) T xl[kSplit ? kTile * LD : 8];  // its remainder
  __shared__ __align__(16) T bs[kTile * LD];   // [j][n]: B
  const int t = threadIdx.x, warp = t >> 5;
  const int nnt = (N + kTile - 1) / kTile;
  const int p0 = (blockIdx.x / nnt) * kTile, n0 = (blockIdx.x % nnt) * kTile;
  const int h = blockIdx.y, b = blockIdx.z / nC, c = blockIdx.z % nC;
  const int s0 = c * Q, nv = min(Q, S - s0);
  if (kGrad && c == 0) return;
  chunk_cumsum(dt + (long long)b * S * H + h, H, s0, nv, Q, A[h], dts, cum);
  const float clast = cum[Q - 1];       // = cum[nv - 1]: dt 0 after
  for (int j = t; j < nv; j += kThreads)
    dts[j] = kGrad ? expf(cum[j]) : dts[j] * expf(clast - cum[j]);
  if (!kGrad && blockIdx.x == 0 && t == 0)
    cdecay[(long long)blockIdx.z * H + h] = clast;
  const T* xb = x + b * sd.xb + (long long)h * P + p0;
  const T* bb = Bm + b * sd.bb + n0;
  float acc[8][4] = {};
  for (int j0 = 0; j0 < nv; j0 += kTile) {
    __syncthreads();                    // last tile's reads done; dts ready
    stage(xb + (long long)(s0 + j0) * sd.xs, sd.xs, kTile, kTile, nv - j0,
          P - p0, sd.vx, [&](int r, int k, uint4 u) {
            float v[VEC];
            widen<T>(u, v);
            const float w = r < nv - j0 ? dts[j0 + r] : 0.f;
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[j] *= w;
            store_as<T, VEC>(xs + r * LD + k, v);
            if constexpr (kSplit) {
              float lo[VEC];
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                lo[j] = v[j] - to_f32(from_f32<T>(v[j]));
              store_as<T, VEC>(xl + r * LD + k, lo);
            }
          });
    stage(bb + (long long)(s0 + j0) * sd.bs, sd.bs, kTile, kTile, nv - j0,
          N - n0, sd.vb, [&](int r, int k, uint4 u) {
            *reinterpret_cast<uint4*>(bs + r * LD + k) = u;
          });
    __syncthreads();
    warp_mma<T, 8, true, true>(acc, xs + warp * 16, LD, bs, LD, kTile);
    if constexpr (kSplit)
      warp_mma<T, 8, true, true>(acc, xl + warp * 16, LD, bs, LD, kTile);
  }
  const int lane = t & 31, g = lane >> 2, tq = lane & 3;
  float* st = states + ((long long)blockIdx.z * H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + warp * 16 + g + 8 * (q >> 1);
      const int n = n0 + nt * 8 + 2 * tq + (q & 1);
      if (p < P && n < N) st[(long long)p * N + n] = acc[nt][q];
    }
}

// Pass 2.  Grid (ceil(P*N/256/V), H, B), V state elements a thread
// (4 when P*N is a multiple of 4).
template <int V>
__global__ void __launch_bounds__(256)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ cdecay,
                      float* __restrict__ final_state, int H, int PN,
                      int nC) {
  using vec = typename std::conditional<V == 4, float4, float>::type;
  const int e = (blockIdx.x * 256 + threadIdx.x) * V;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  float s[V] = {};
  for (int c = 0; c < nC; ++c) {
    const long long bch = ((long long)b * nC + c) * H + h;
    vec* slot = reinterpret_cast<vec*>(states + bch * PN + e);
    const vec local = *slot;
    const float d = expf(cdecay[bch]);
    const float* lf = reinterpret_cast<const float*>(&local);
    vec out;
    float* of = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      of[v] = s[v];                     // the state entering chunk c
      s[v] = fmaf(d, s[v], lf[v]);
    }
    *slot = out;
  }
  vec fin;
#pragma unroll
  for (int v = 0; v < V; ++v) reinterpret_cast<float*>(&fin)[v] = s[v];
  *reinterpret_cast<vec*>(final_state + ((long long)b * H + h) * PN + e) = fin;
}

// Dynamic shared memory of pass 3 for (Q, N): dt and cum, C and B (or
// S_c) over the padded state size, W and x, a tile's decay factors.
template <typename T>
__host__ __device__ constexpr size_t scan_smem(int Q, int N) {
  return 2 * sizeof(float) * ((Q + 3) & ~3) +
         sizeof(T) * kTile *
             (2 * (round16(N) + pad<T>()) + 2 * (kTile + pad<T>())) +
         sizeof(float) * kTile;
}

// Pass 3.  Grid (ceil(Q/64) * ceil(P/64), H, B * nC).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm,
                      const float* __restrict__ states, T* __restrict__ y,
                      int S, int H, int P, int N, int Q, int nC, Strides sd) {
  extern __shared__ float4 smem4[];
  const int Np = round16(N), LDN = Np + pad<T>(), LDJ = kTile + pad<T>();
  float* dts = reinterpret_cast<float*>(smem4);
  float* cum = dts + ((Q + 3) & ~3);
  T* cs = reinterpret_cast<T*>(cum + ((Q + 3) & ~3));  // [i][n]: C
  T* bs = cs + kTile * LDN;             // [p][n]: S_c, then [j][n]: B
  T* ws = bs + kTile * LDN;             // [i][j]: W
  T* xs = ws + kTile * LDJ;             // [j][p]: x
  float* fj = reinterpret_cast<float*>(xs + kTile * LDJ);  // [j]
  const int t = threadIdx.x, warp = t >> 5;
  const int lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int npt = (P + kTile - 1) / kTile;
  const int i0 = (blockIdx.x / npt) * kTile;
  const int p0 = (blockIdx.x % npt) * kTile;
  const int h = blockIdx.y, b = blockIdx.z / nC, c = blockIdx.z % nC;
  const int s0 = c * Q, nv = min(Q, S - s0);
  if (i0 >= nv) return;                 // whole block past S
  chunk_cumsum(dt + (long long)b * S * H + h, H, s0, nv, Q, A[h], dts, cum);
  const T* xb = x + b * sd.xb + (long long)h * P + p0;
  const T* bb = Bm + b * sd.bb;
  auto copy_to = [](T* dst, int ld) {
    return [dst, ld](int r, int k, uint4 u) {
      *reinterpret_cast<uint4*>(dst + r * ld + k) = u;
    };
  };
  stage(Cm + b * sd.cb + (long long)(s0 + i0) * sd.cs, sd.cs, kTile, Np,
        nv - i0, N, sd.vc, copy_to(cs, LDN));
  float accy[8][4] = {};
  if (c > 0) {                          // y = exp(cum_i) C_i . S_c[p] first
    const float* st = states + ((long long)blockIdx.z * H + h) * P * N +
                      (long long)p0 * N;
    stage(st, N, kTile, Np, P - p0, N, (N & 3) == 0,
          [&](int r, int k, uint4 u) {
            float v[4];
            widen<float>(u, v);
            store_as<T, 4>(bs + r * LDN + k, v);
          });
    __syncthreads();
    warp_mma<T, 8, false, false>(accy, cs + warp * 16 * LDN, LDN, bs, LDN,
                                 Np);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + warp * 16 + g + 8 * (q >> 1);
      const float ei = i < nv ? expf(cum[i]) : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) accy[nt][q] *= ei;
    }
  }
  const int iend = min(nv, i0 + kTile);
  for (int j0 = 0; j0 < iend; j0 += kTile) {
    __syncthreads();                    // bs and xs free
    stage(bb + (long long)(s0 + j0) * sd.bs, sd.bs, kTile, Np, nv - j0, N,
          sd.vb, copy_to(bs, LDN));
    stage(xb + (long long)(s0 + j0) * sd.xs, sd.xs, kTile, kTile, nv - j0,
          P - p0, sd.vx, copy_to(xs, LDJ));
    const int jr = j0 + kTile - 1;      // below every i when j0 < i0
    if (j0 < i0 && t < kTile) fj[t] = expf(cum[jr] - cum[j0 + t]) * dts[j0 + t];
    __syncthreads();
    float accg[8][4] = {};              // G[i][j] = C_i . B_j
    warp_mma<T, 8, false, false>(accg, cs + warp * 16 * LDN, LDN, bs, LDN,
                                 Np);
    // W = G exp(cum_i - cum_j) dt_j for j <= i, into the warp's own rows:
    // below the diagonal as exp(cum_i - cum_jr) exp(cum_jr - cum_j), both
    // factors <= 1; on it directly, only for j <= i
    if (j0 < i0) {
      float ei[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + warp * 16 + g + 8 * hh;
        ei[hh] = i < nv ? expf(cum[i] - cum[jr]) : 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int jl = nt * 8 + 2 * tq;
        const float2 f = *reinterpret_cast<const float2*>(fj + jl);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          store2<T>(ws + (warp * 16 + g + 8 * hh) * LDJ + jl,
                    accg[nt][2 * hh] * ei[hh] * f.x,
                    accg[nt][2 * hh + 1] * ei[hh] * f.y);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int il = warp * 16 + g + 8 * hh, jl = nt * 8 + 2 * tq;
          const int i = i0 + il, j = j0 + jl;
          float w[2] = {0.f, 0.f};
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (j + u <= i && i < nv)
              w[u] = accg[nt][2 * hh + u] * expf(cum[i] - cum[j + u]) *
                     dts[j + u];
          store2<T>(ws + il * LDJ + jl, w[0], w[1]);
        }
    }
    __syncwarp();
    warp_mma<T, 8, false, true>(accy, ws + warp * 16 * LDJ, LDJ, xs, LDJ,
                                kTile);
  }
  // y through shared memory (the x tile's space), out in 16-byte rows
  __syncthreads();                      // every warp is done with xs
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      store2<T>(xs + (warp * 16 + g + 8 * hh) * LDJ + nt * 8 + 2 * tq,
                accy[nt][2 * hh], accy[nt][2 * hh + 1]);
  __syncthreads();
  constexpr int VEC = 16 / (int)sizeof(T);
  T* yb = y + (((long long)b * S + s0 + i0) * H + h) * P + p0;
  const long long ys = (long long)H * P;
  for (int e = t; e < kTile * (kTile / VEC); e += kThreads) {
    const int r = e / (kTile / VEC), k = (e % (kTile / VEC)) * VEC;
    if (i0 + r >= nv) continue;
    const T* src = xs + r * LDJ + k;
    if (sd.vy && p0 + k + VEC <= P) {
      *reinterpret_cast<uint4*>(yb + r * ys + k) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < VEC && p0 + k + j < P; ++j)
        yb[r * ys + k + j] = src[j];
    }
  }
}

// Pass 3's largest shared memory, opted into once per device and dtype.
template <typename T>
cudaError_t opt_in() {
  constexpr size_t kMax = scan_smem<T>(QMAX, NMAX);
  static_assert(kMax <= 227 * 1024, "pass 3 tiles exceed an SM");
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMax);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, float* states,
           float* cdecay, int B, int S, int H, int P, int N, int Q,
           const Strides& sd, cudaStream_t st) {
  const int nC = (S + Q - 1) / Q;
  const int ptiles = (P + kTile - 1) / kTile;
  if ((long long)B * nC > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in<T>();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_kernel<T>
      <<<dim3(ptiles * ((N + kTile - 1) / kTile), H, B * nC), kThreads, 0,
         st>>>((const T*)x, dt, A, (const T*)Bm, states, cdecay, S, H, P, N,
               Q, nC, sd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if ((P * N) % 4 == 0)
    ssd_state_pass_kernel<4><<<dim3((P * N / 4 + 255) / 256, H, B), 256, 0,
                                st>>>(states, cdecay, state, H, P * N, nC);
  else
    ssd_state_pass_kernel<1><<<dim3((P * N + 255) / 256, H, B), 256, 0, st>>>(
        states, cdecay, state, H, P * N, nC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<T>
      <<<dim3(((Q + kTile - 1) / kTile) * ptiles, H, B * nC), kThreads,
         scan_smem<T>(Q, N), st>>>((const T*)x, dt, A, (const T*)Bm,
                                   (const T*)Cm, states, (T*)y, S, H, P, N,
                                   Q, nC, sd);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------- backward
//
// The gradients of (x, dt, A, Bm, Cm) from those of y and of the final
// state, for _SSDScan.backward (kernels/ssd_scan/ops.py) on the card.  It
// replaces no TPU kernel: the Pallas ssd_scan has no backward, and the
// reference trains through XLA's autodiff of models/layers.py
// ssd_chunked.  It was added because the training path's only other
// route on the card was the plain version recomputed under autograd (24
// ms and 4.4 GB extra a call at mamba2-train's shape).
//
// What bounds it on the H100: bytes.  At mamba2-train's shape (B 4,
// S 4,096, H 48, P 64, N 128, Q 256, bf16) its inputs and outputs are
// 325 MB (0.097 ms at 3.35 TB/s).  The products the function needs are
// 88.7 GFLOP (0.090 ms at the bf16 tensor-core rate): dG^T C and dG B
// are linear in dG and B, C are shared by every head, so they are needed
// once a chunk on the head sum of dG; its elementwise work, 0.8 G float32
// operations, takes 0.012 ms beside the tensor cores.  The loops below
// issue 122 GFLOP of mma.sync at that shape and one head group
// (chip_smoke.py _ssd_backward_issued): the chunk states twice (pass 1
// and 1', each x o dt o decay split hi + lo), the carry's and the
// state's per-head products, dW and W^T gy per head and pair, and, per
// head group, C B^T once a tile pair and dG^T C, dG B once a tile pair.
//
// Nothing is saved by the forward: passes 1-2 run again for the
// state entering each chunk, S_c.  Then, with R_c the gradient of the
// state leaving chunk c (R of the last chunk = the final state's
// gradient, or zero), L_c = cum_last and u_j = exp(L_c - cum_j) dt_j:
//   1'. D_c = sum_i exp(cum_i) gy_i C_i^T per (batch, chunk > 0, head):
//       pass 1 with kGrad.
//   2'. R_{c-1} = exp(L_c) R_c + D_c from the last chunk to the first
//       (ssd_state_grad_kernel), each block's share of exp(L_c)
//       <R_c, S_c>, the gradient of L_c through the carry, and R_c and
//       S_c rounded once to the inputs' dtype: the product operands of
//       pass 3', half the bytes of float32 and ready for cp.async.
//   3'. ssd_bwd_cum_kernel: each (batch, chunk, head)'s cum and dt as one
//       contiguous row.  ssd_bwd_col_kernel, a block of 8 warps per (64
//       positions j, head group, batch x chunk), with j as its rows (4
//       strips of 16) and each i-tile's columns in 2 halves of 32.
//       Before its head loop it forms G^T = B_j C_i^T for every i-tile
//       >= j (C_i staged once a tile) and keeps it in shared memory as
//       float32 fragments, each thread's own, beside a zeroed float32
//       tile of the group's sum of dG^T.  Then, per head:
//       gx_j = u_j B_j R^T + W^T gy and gB_j += u_j (x_j R) (the carry),
//       and per i-tile dW^T = x_j gy_i^T, W^T = G^T E dt_j and
//       dG^T = dW^T E dt_j (E = exp(cum_i - cum_j), formed only for
//       j <= i: per element on the diagonal tile, below it as
//       exp(cum_i - cum_jr) (once a head) times exp(cum_jr - cum_j)),
//       the column sums of dW G E (a quad shuffle) and its row sums
//       dt_j-weighted (three halving shuffles, then the strips in order,
//       into per-j-tile partials): W^T feeds W^T gy from registers (the
//       accumulator fragments are the mma's A operand), dG^T is added to
//       the group's sum, and the two column halves' parts of gx meet in
//       shared memory at the head's end.  After the loop the sum is
//       rounded once to the inputs' dtype and written out as one 64 x 64
//       tile a pair.  The grid runs j-tile-major, so the blocks with the
//       most i-tiles start first.  ssd_bwd_bc_kernel, a block per (64
//       positions t, head group, batch x chunk): gB_t += sum_i dG_ti^T
//       C_i and gC_t = sum_j dG_jt B_j (each C_i, B_j staged once, each
//       product once a pair and group), then per head the state's term
//       gC_t += exp(cum_t) gy_t S_c and the row sums: the column kernel's
//       partials in j-tile order plus exp(cum_t) C_t . (gy_t S_c).
//   4'. ssd_bwd_dt_kernel, a block per (head, batch x chunk): the
//       gradient of cum at each position from the row and column sums,
//       its reverse cumsum within the chunk, then gdt and the chunk's
//       share of gA.
//   5'. ssd_bwd_sum_bc_kernel sums the head groups' float32 gB and gC in
//       group order and casts them; ssd_bwd_sum_a_kernel sums gA's shares
//       in (batch, chunk) order.  No atomics: a call's result does not
//       change from run to run.
// The per-head tiles of pass 3' (x_j, gy_i, R_c, S_c, cum, dt) come in
// by cp.async into rings of shared memory two items ahead of the one in
// use, so the next head's tiles land while this head's products run.
// Q > 256 (ki() i-tiles a pass: 4 for bf16, 2 for float32) runs the
// column kernel's head loop once a pass over the i-tiles that fit,
// carrying gx in a float32 scratch between passes.  At (Q 256, N 128,
// bf16) the column kernel holds 214.5 KB of shared memory and 236
// registers a thread, no spills (one block an SM: 8 warps), the bc kernel
// 101.0 KB and 247 (two blocks an SM); kernel._groups therefore aims at
// one column block an SM, and fewer groups form C B^T and the dG
// products fewer times (one group at mamba2-train's shape).
// Roundings for bfloat16 inputs: the operands formed in float32 (W, the
// group's sum of dG, R_c and S_c) are rounded to bfloat16 for the
// product, as the forward rounds W and S_c, and pass 1' splits
// gy o exp(cum) into head and remainder as pass 1 does; gdt and gA are
// float32 throughout.  dG is summed over a head group in float32 and
// rounded once, so gB and gC round once a group, and the rounding
// depends on the split into groups (kernel._groups, from the SM count).
// The kernel differentiates its own forward (C B^T in float32, W rounded
// only as a product's operand), not the plain version's bfloat16 Gram
// matrix.  P <= 64 and N <= 128: a block keeps a 64 x P and a 64 x N
// accumulator.

constexpr int kPMaxBwd = 64;
constexpr int kNMaxBwd = 128;
constexpr int kRing = 3;                // slots of a staged tile stream

// i-tiles the column kernel holds at once: G^T and the group's dG^T as
// float32 fragments, 16 KB each a tile.
template <typename T>
__host__ __device__ constexpr int ki() { return sizeof(T) == 2 ? 4 : 2; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Starts copying the tile src[r * lds + k] (r < rows, k < COLS, COLS a
// multiple of 16 bytes of Ts; zero at or past nrow or ncol) to
// dst[r * ldd + k]: cp.async of 16 bytes a chunk when `vec` (src and lds
// 16-byte aligned), plain loads and stores otherwise.  The caller
// commits the group.
template <int COLS, typename Ts>
__device__ __forceinline__ void stage_async(Ts* dst, int ldd,
                                            const Ts* __restrict__ src,
                                            long long lds, int rows,
                                            int nrow, int ncol, bool vec) {
  constexpr int VEC = 16 / (int)sizeof(Ts), PER_ROW = COLS / VEC;
  static_assert(COLS % VEC == 0, "whole 16-byte chunks");
  for (int e = threadIdx.x; e < rows * PER_ROW; e += blockDim.x) {
    const int r = e / PER_ROW, k = (e % PER_ROW) * VEC;
    const int valid = r < nrow ? min(VEC, max(0, ncol - k)) : 0;
    Ts* d = dst + r * ldd + k;
    const Ts* s = src + r * lds + k;
    if (vec)
      cp_async16(d, valid > 0 ? s : src, valid * (int)sizeof(Ts));
    else
      *reinterpret_cast<uint4*>(d) = fetch16(s, valid, false);
  }
}

// Starts copying n floats (n a multiple of 4, src 16-byte aligned; zero
// at or past nvalid) from src to dst.  The caller commits the group.
__device__ __forceinline__ void stage_floats_async(float* dst,
                                                   const float* src, int n,
                                                   int nvalid) {
  for (int e = threadIdx.x * 4; e < n; e += blockDim.x * 4) {
    const int valid = min(4, max(0, nvalid - e));
    cp_async16(dst + e, valid > 0 ? src + e : src, valid * 4);
  }
}

// The float4 slot of this thread's m16n8 fragment nt (< 4) of tile m in
// an array of per-thread fragments of 8 warps: a warp reads 512
// contiguous bytes.
__device__ __forceinline__ int frag(int m, int nt) {
  return ((m * 8 + (threadIdx.x >> 5)) * 4 + nt) * 32 + (threadIdx.x & 31);
}

// acc[nt] += A[16 x 8 KF] . B[8 KF x 8 NT] for the warp's 16 rows, with A
// in registers as the m16n8 fragments warp_mma leaves (w[kt]: columns
// 8 kt to 8 kt + 7) and B stored [k][n] with row length ldb.  bfloat16:
// two fragments are one m16n8k16 A operand, rounded here; float32: each
// element is fetched from the lane that holds it.
template <typename T, int NT, int KF>
__device__ __forceinline__ void warp_mma_frag(float (&acc)[NT][4],
                                              const float (&w)[KF][4],
                                              const T* __restrict__ Bs,
                                              int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    const int mi = lane >> 3, r = lane & 7;
    auto pack = [](float lo, float hi) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
      return *reinterpret_cast<const uint32_t*>(&h);
    };
#pragma unroll
    for (int kk = 0; kk < KF / 2; ++kk) {
      const uint32_t a[4] = {pack(w[2 * kk][0], w[2 * kk][1]),
                             pack(w[2 * kk][2], w[2 * kk][3]),
                             pack(w[2 * kk + 1][0], w[2 * kk + 1][1]),
                             pack(w[2 * kk + 1][2], w[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        ldsm_x4_trans(
            Bs + (16 * kk + (mi & 1) * 8 + r) * ldb + (nt + (mi >> 1)) * 8,
            b[0], b[1], b[2], b[3]);
        mma_bf16(acc[nt], a, b[0], b[1]);
        mma_bf16(acc[nt + 1], a, b[2], b[3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8 * KF; ++k) {
      const int src = g * 4 + ((k & 7) >> 1);
      const float a0 = __shfl_sync(kFull, w[k >> 3][k & 1], src);
      const float a1 = __shfl_sync(kFull, w[k >> 3][2 + (k & 1)], src);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = Bs[k * ldb + nt * 8 + 2 * t];
        const float b1 = Bs[k * ldb + nt * 8 + 2 * t + 1];
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  }
}

// The sum of v over the block (128 threads), in a fixed order; every
// thread gets it.  `red` holds 4 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  __syncthreads();                      // red free from a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return (red[0] + red[1]) + (red[2] + red[3]);
}

// Sum over the 4 lanes of a quad: the threads that hold one row of an
// m16n8 fragment.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Column sums of the warp's 16 x 32 tile: v[nt][u] is this thread's sum
// over its two rows of column 8 nt + 2 t + u.  Three halving steps over
// the lanes that share t, in a fixed order, leave in lane (g, t) the sum
// over all 16 rows of column 8 (g >> 1) + 2 t + (g & 1).
__device__ __forceinline__ float col_sums(const float (&v)[4][2]) {
  const int lane = threadIdx.x & 31;
  const bool b2 = lane & 16, b1 = lane & 8, b0 = lane & 4;
  float s4[4], s2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {         // n-tiles 0-1 or 2-3
    const float lo = v[k >> 1][k & 1], hi = v[2 + (k >> 1)][k & 1];
    s4[k] = (b2 ? hi : lo) + __shfl_xor_sync(kFull, b2 ? lo : hi, 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    s2[k] = (b1 ? s4[k + 2] : s4[k]) +
            __shfl_xor_sync(kFull, b1 ? s4[k] : s4[k + 2], 8);
  return (b0 ? s2[1] : s2[0]) + __shfl_xor_sync(kFull, b0 ? s2[0] : s2[1], 4);
}

// Pass 2'.  Grid (ceil(P*N/256/V), H, B).  rstates holds D_c for c > 0;
// rt and st get R_c (the gradient of the state leaving chunk c) and S_c
// (the state entering it, from states) in T, and gl[(b nC + c) H +
// h][blockIdx.x] this block's share of exp(L_c) <R_c, S_c> (float32).
// g_state may be null (zero).
template <typename T, int V>
__global__ void __launch_bounds__(256)
ssd_state_grad_kernel(const float* __restrict__ rstates,
                      const float* __restrict__ states,
                      const float* __restrict__ cdecay,
                      const float* __restrict__ g_state, T* __restrict__ rt,
                      T* __restrict__ st, float* __restrict__ gl, int H,
                      int PN, int nC) {
  __shared__ float red[8];
  const int e = (blockIdx.x * 256 + threadIdx.x) * V;
  const bool live = e < PN;
  const int h = blockIdx.y, b = blockIdx.z;
  float r[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    r[v] = live && g_state ? g_state[((long long)b * H + h) * PN + e + v]
                           : 0.f;
  for (int c = nC - 1; c >= 0; --c) {
    const long long bch = ((long long)b * nC + c) * H + h;
    const float d = expf(cdecay[bch]);
    float dot = 0.f;
    if (live) {
      const long long o = bch * PN + e;
      float sv[V], rv[V], dc[V];
      if constexpr (V == 4) {
        widen<float>(*reinterpret_cast<const uint4*>(states + o), sv);
        if (c > 0)
          widen<float>(*reinterpret_cast<const uint4*>(rstates + o), dc);
      } else {
        sv[0] = states[o];
        if (c > 0) dc[0] = rstates[o];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        rv[v] = r[v];
        dot = fmaf(r[v], sv[v], dot);
        r[v] = fmaf(d, r[v], c > 0 ? dc[v] : 0.f);
      }
      if constexpr (V == 4) {
        store_as<T, 4>(rt + o, rv);
        store_as<T, 4>(st + o, sv);
      } else {
        rt[o] = from_f32<T>(rv[0]);
        st[o] = from_f32<T>(sv[0]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(kFull, dot, off);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = dot;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < 8; ++w) s += red[w];
      gl[bch * gridDim.x + blockIdx.x] = d * s;
    }
  }
}

// Pass 3', cum.  Grid (H, B * nC).  Row (b nC + c) H + h of cum_out and
// dts_out (Qa = Q rounded up to 4 floats): the inclusive cumsum of dt A
// within the chunk (its last value past the chunk) and dt (0 past S).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                   float* __restrict__ cum_out, float* __restrict__ dts_out,
                   int S, int H, int Q, int nC) {
  __shared__ float dts[QMAX], cum[QMAX];
  const int h = blockIdx.x, b = blockIdx.y / nC, c = blockIdx.y % nC;
  const int s0 = c * Q, nv = min(Q, S - s0), Qa = (Q + 3) & ~3;
  chunk_cumsum(dt + (long long)b * S * H + h, H, s0, nv, Q, A[h], dts, cum);
  const long long row = ((long long)blockIdx.y * H + h) * Qa;
  for (int j = threadIdx.x; j < Qa; j += kThreads) {
    cum_out[row + j] = cum[min(j, Q - 1)];
    dts_out[row + j] = j < Q ? dts[j] : 0.f;
  }
}

// Leading dimensions of the backward's tiles: NC = 64 or 128 columns of
// B, C and the states; 64 of x, gy and dG.
template <typename T>
__host__ __device__ constexpr int ldn(int NC) { return NC + pad<T>(); }
template <typename T>
__host__ __device__ constexpr int ld64() { return kTile + pad<T>(); }

template <typename T>
__host__ __device__ constexpr size_t col_smem(int Q, int NC) {
  return sizeof(float) * (2 * ki<T>() * kTile * kTile + 2 * ((Q + 3) & ~3) +
                          2 * kTile + 5 * ki<T>() * kTile) +
         sizeof(T) * kTile * (2 * ldn<T>(NC) + (2 + kRing) * ld64<T>());
}
template <typename T>
__host__ __device__ constexpr size_t bc_smem(int Q, int NC) {
  return sizeof(float) * kRing *
             (((Q + 3) & ~3) + (Q + kTile - 1) / kTile * kTile) +
         sizeof(T) * kTile * ((1 + kRing) * ldn<T>(NC) + kRing * ld64<T>());
}

struct BwdArgs {
  const void *x, *Bm, *Cm, *gy;
  const float *dt, *A;
  const void *rt, *st;                  // R_c, S_c in T (B, nC, H, P, N)
  const float *cum, *dts;               // (B, nC, H, Qa) float32
  void* gx;
  void* dgs;      // (HG, B nC, nqt, nqt, 64, 64) T: the groups' dG^T tiles
  float *part_b, *part_c;               // (HG, B, S, N) float32
  float *rowp, *colp, *gdtd, *tloc;     // (B, S, H) float32
  float* rowpart;                       // (nqt, B nC, H, 64 nqt) float32
  float* gxacc;                         // (B, S, H, P) float32, Q > 64 ki()
  int B, S, H, P, N, Q, nC, hpg;
  Strides sd;                           // x, Bm, Cm as in the forward
  long long gyb, gys;
  int vgy, vst;
};

constexpr int kColThreads = 256;        // 8 warps

// Pass 3', columns.  Grid (B * nC, HG, ceil(Q/64)), so that the j-tiles
// with the most i-tiles start first, and 8 warps: warp w holds
// rows 16 (w % 4) to 16 (w % 4) + 15 of the j-tile and columns 32 (w / 4)
// to 32 (w / 4) + 31 of each i-tile (and of N for the carry's x_j R); the
// two column halves' partial sums of gx_j meet in shared memory at each
// head's end.
template <typename T, int NTN>
__global__ void __launch_bounds__(kColThreads, 1)
ssd_bwd_col_kernel(BwdArgs a) {
  constexpr int NC = NTN * 8, KI = ki<T>(), NH = NTN / 2;
  constexpr int LDN = ldn<T>(NC), LDP = ld64<T>();
  extern __shared__ float4 smem4[];
  const int Q = a.Q, Qa = (Q + 3) & ~3;
  float4* gf = smem4;                   // G^T fragments, KI tiles
  float4* sdg = gf + KI * 1024;         // the group's sum of dG^T, likewise
  float* cumb = reinterpret_cast<float*>(sdg + KI * 1024);  // [2][Qa]
  float* dtsb = cumb + 2 * Qa;          // [2][64]: dt_j
  float* red = dtsb + 2 * kTile;        // [strip][KI * 64]: row sums
  float* fib = red + 4 * KI * kTile;    // [KI * 64]: exp(cum_i - cum_jr)
  T* bj = reinterpret_cast<T*>(fib + KI * kTile);  // [j][n]: B_j
  T* rb = bj + kTile * LDN;             // [p][n]: R_c; [i][n]: C_i for G
  T* xb = rb + kTile * LDN;             // [2][j][p]: x_j
  T* yb = xb + 2 * kTile * LDP;         // [kRing][i][p]: gy_i
  const int t = threadIdx.x, warp = t >> 5, rw = warp & 3, ch = warp >> 2;
  const int lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int jt = blockIdx.z, j0 = jt * kTile, jl0 = rw * 16 + g;
  const int c0 = ch * 32;               // the warp's first column
  const long long bc = blockIdx.x, bnc = (long long)a.B * a.nC;
  const int b = blockIdx.x / a.nC, c = blockIdx.x % a.nC;
  const int S = a.S, H = a.H, P = a.P, N = a.N;
  const int s0 = c * Q, nv = min(Q, S - s0);
  if (j0 >= nv) return;
  const int ntile = (nv + kTile - 1) / kTile, nqt = (Q + kTile - 1) / kTile;
  const int Np = round16(N), Pp = round16(P);
  const int kh = (Np / 16 + 1) / 2 * 16;  // B_j R^T's depth, half 0
  const int k_lo = ch ? kh : 0, k_n = ch ? Np - kh : kh;
  const int h_lo = blockIdx.y * a.hpg, nh = min(H, h_lo + a.hpg) - h_lo;
  const int jr = min(j0 + kTile - 1, Q - 1);  // below every i off the diagonal
  const Strides& sd = a.sd;
  const T* xsrc = (const T*)a.x + b * sd.xb + (long long)(s0 + j0) * sd.xs;
  const T* gysrc = (const T*)a.gy + b * a.gyb + (long long)s0 * a.gys;
  stage_async<NC>(bj, LDN,
                  (const T*)a.Bm + b * sd.bb + (long long)(s0 + j0) * sd.bs,
                  sd.bs, kTile, nv - j0, N, sd.vb);
  cp_async_commit();
  float accb[NH][4] = {};               // gB_j's carry term over the group
  for (int ip0 = jt; ip0 < ntile; ip0 += KI) {   // passes over the i-tiles
    const int nk = min(KI, ntile - ip0), per = 1 + nk, n_items = nh * per;
    const bool first = ip0 == jt, last = ip0 + KI >= ntile;
    // G^T = B_j C_i^T of the pass's i-tiles, once for all the heads
    for (int m = 0; m < nk; ++m) {
      const int i0 = (ip0 + m) * kTile;
      stage_async<NC>(rb, LDN,
                      (const T*)a.Cm + b * sd.cb + (long long)(s0 + i0) * sd.cs,
                      sd.cs, kTile, nv - i0, N, sd.vc);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float acc[4][4] = {};
      warp_mma<T, 4, false, false>(acc, bj + rw * 16 * LDN, LDN,
                                   rb + c0 * LDN, LDN, Np);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        gf[frag(m, nt)] = make_float4(acc[nt][0], acc[nt][1], acc[nt][2],
                                      acc[nt][3]);
        sdg[frag(m, nt)] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();                  // rb free
    }
    // The tile stream: per head an item of its x_j, cum, dt (and, in the
    // first pass, R_c), then one of gy_i per i-tile.  Item n + 2 is
    // started while item n is used.
    auto issue = [&](int n) {
      if (n < n_items) {
        const int k = n / per, m = n % per - 1, h = h_lo + k;
        const long long row = bc * H + h;
        if (m < 0) {
          stage_async<kTile>(xb + (k & 1) * kTile * LDP, LDP,
                             xsrc + (long long)h * P, sd.xs, kTile, nv - j0,
                             P, sd.vx);
          stage_floats_async(cumb + (k & 1) * Qa, a.cum + row * Qa, Qa, Qa);
          stage_floats_async(dtsb + (k & 1) * kTile, a.dts + row * Qa + j0,
                             kTile, Qa - j0);
          if (first)
            stage_async<NC>(rb, LDN, (const T*)a.rt + row * P * N, N, kTile,
                            P, N, a.vst);
        } else {
          const int i0 = (ip0 + m) * kTile;
          stage_async<kTile>(yb + (n - k - 1) % kRing * kTile * LDP, LDP,
                             gysrc + (long long)i0 * a.gys + (long long)h * P,
                             a.gys, kTile, nv - i0, P, a.vgy);
        }
      }
      cp_async_commit();                // an empty group past the end
    };
    issue(0);
    issue(1);
    float accx[8][4];                   // gx_j of the head: this half's part
    float du[2], cge[2], u[2], ej[2], dtj[2], fj[2], cj[2];
    for (int n = 0; n < n_items; ++n) {
      cp_async_wait<1>();               // item n has landed
      __syncthreads();                  // ... for every thread; n - 1 done
      const int k = n / per, m = n % per - 1, h = h_lo + k;
      // with one i-tile a pass, item n + 2 is the next head's R_c, which
      // lands where this item's R_c is read: start it after the reads
      const bool defer = first && m < 0 && nk == 1;
      if (!defer) issue(n + 2);
      const float* cum = cumb + (k & 1) * Qa;
      const T* xj = xb + (k & 1) * kTile * LDP;
      if (m < 0) {                      // the head's start
        const float L = cum[Q - 1], cr = cum[jr];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int jl = jl0 + 8 * hh, j = j0 + jl;
          cj[hh] = j < nv ? cum[j] : 0.f;
          dtj[hh] = dtsb[(k & 1) * kTile + jl];
          ej[hh] = j < nv ? expf(L - cj[hh]) : 0.f;
          fj[hh] = j < nv ? expf(cr - cj[hh]) : 0.f;
          u[hh] = ej[hh] * dtj[hh];
          du[hh] = cge[hh] = 0.f;
        }
        // E's factor of each i below the diagonal tile, for this head
        for (int e = t; e < nk * kTile; e += kColThreads) {
          const int i = ip0 * kTile + e;
          fib[e] = i > jr && i < nv ? expf(cum[i] - cr) : 0.f;
        }
        if (first) {
          // the carry's terms: gx_j = u_j B_j R^T (each half over half of
          // N), V_j = x_j R (each half its half of N), gB_j += u_j V_j
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) accx[nt][q] = 0.f;
          warp_mma<T, 8, false, false>(accx, bj + rw * 16 * LDN + k_lo, LDN,
                                       rb + k_lo, LDN, k_n);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) accx[nt][q] *= u[q >> 1];
          float accv[NH][4] = {};
          warp_mma<T, NH, false, true>(accv, xj + rw * 16 * LDP, LDP,
                                       rb + ch * NH * 8, LDN, Pp);
#pragma unroll
          for (int nt = 0; nt < NH; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int jl = jl0 + 8 * (q >> 1);
              const int nn = ch * NH * 8 + nt * 8 + 2 * tq + (q & 1);
              du[q >> 1] += accv[nt][q] * to_f32(bj[jl * LDN + nn]);
              accb[nt][q] += u[q >> 1] * accv[nt][q];
            }
        } else {                        // gx_j of the earlier passes
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = j0 + jl0 + 8 * hh;
            const float* src =
                a.gxacc + (((long long)b * S + s0 + j) * H + h) * P;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int v = 0; v < 2; ++v) {
                const int p = nt * 8 + 2 * tq + v;
                accx[nt][2 * hh + v] =
                    nt / 4 == ch && j < nv && p < P ? src[p] : 0.f;
              }
          }
        }
      } else {                          // the pair (i-tile ip0 + m, j)
        const int it = ip0 + m, i0 = it * kTile;
        const T* gyi = yb + (n - k - 1) % kRing * kTile * LDP;
        const bool diag = it == jt;
        float accd[4][4] = {};          // dW^T = x_j gy_i^T
        warp_mma<T, 4, false, false>(accd, xj + rw * 16 * LDP, LDP,
                                     gyi + c0 * LDP, LDP, Pp);
        // E, G E and W^T = G E dt_j need no dW: formed while its product
        // runs
        float ed[4][4], gE[4][4], w[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float4 g4 = gf[frag(m, nt)];
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
          const float2 fi = *reinterpret_cast<const float2*>(
              fib + m * kTile + c0 + nt * 8 + 2 * tq);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int hh = q >> 1, v = q & 1;
            const int i = i0 + c0 + nt * 8 + 2 * tq + v;
            const int j = j0 + jl0 + 8 * hh;
            float e;
            if (diag)
              e = j <= i && i < nv ? expf(cum[i] - cj[hh]) : 0.f;
            else
              e = (v ? fi.y : fi.x) * fj[hh];
            ed[nt][q] = e * dtj[hh];
            gE[nt][q] = gv[q] * e;
            w[nt][q] = gv[q] * ed[nt][q];
          }
        }
        float rs[4][2];                 // dW G E dt_j over this thread's j
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float4 s4 = sdg[frag(m, nt)];
          float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          rs[nt][0] = rs[nt][1] = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int hh = q >> 1, v = q & 1;
            const float dw = accd[nt][q], mv = dw * gE[nt][q];
            sv[q] += dw * ed[nt][q];    // dG^T into the group's sum
            cge[hh] += mv;
            rs[nt][v] += mv * dtj[hh];
          }
          sdg[frag(m, nt)] = make_float4(sv[0], sv[1], sv[2], sv[3]);
        }
        warp_mma_frag<T, 8, 4>(accx, w, gyi + c0 * LDP, LDP);
        red[rw * KI * kTile + m * kTile + c0 + (g >> 1) * 8 + 2 * tq +
            (g & 1)] = col_sums(rs);
      }
      if (defer) {
        __syncthreads();                // every warp is done with R_c
        issue(n + 2);
      }
      if (m == nk - 1) {                // the head's end
        // half 1's partials of gx (p < 32) and of the row's sums go through
        // the gy slot no item uses now (items n + 1, n + 2 are in flight)
        float* xch = reinterpret_cast<float*>(
            yb + (n - k + 1) % kRing * kTile * LDP);
        float4* xch4 = reinterpret_cast<float4*>(xch);
        float* xr = xch + 2048;         // [row][2]: cge, du
        float ge[2], d[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          ge[hh] = quad_sum(cge[hh]);
          d[hh] = quad_sum(du[hh]);
        }
        if (ch) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            xch4[(rw * 4 + nt) * 32 + lane] = make_float4(
                accx[nt][0], accx[nt][1], accx[nt][2], accx[nt][3]);
          if (tq == 0)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              xr[(jl0 + 8 * hh) * 2] = ge[hh];
              xr[(jl0 + 8 * hh) * 2 + 1] = d[hh];
            }
        }
        __syncthreads();                // red and half 1's partials
        const long long rrow =
            (((long long)jt * bnc + bc) * H + h) * (nqt * kTile);
        constexpr int W = KI * kTile;
        for (int e = t; e < nk * kTile; e += kColThreads) {
          const int i = ip0 * kTile + e;
          if (i < nv)
            a.rowpart[rrow + i] =
                (red[e] + red[W + e]) + (red[2 * W + e] + red[3 * W + e]);
        }
        auto put_gx = [&](int nt0) {    // n-tiles nt0 .. nt0 + 3 of gx_j
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = j0 + jl0 + 8 * hh;
            if (j >= nv) continue;
            const long long o = ((long long)b * S + s0 + j) * H + h;
            if (last) {
              T* gxr = (T*)a.gx + o * P;
#pragma unroll
              for (int nt = nt0; nt < nt0 + 4; ++nt) {
                const int p = nt * 8 + 2 * tq;
                if (p + 1 < P && (P & 1) == 0) {
                  store2<T>(gxr + p, accx[nt][2 * hh], accx[nt][2 * hh + 1]);
                } else {
                  if (p < P) gxr[p] = from_f32<T>(accx[nt][2 * hh]);
                  if (p + 1 < P)
                    gxr[p + 1] = from_f32<T>(accx[nt][2 * hh + 1]);
                }
              }
            } else {
              float* acc = a.gxacc + o * P;
#pragma unroll
              for (int nt = nt0; nt < nt0 + 4; ++nt)
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                  const int p = nt * 8 + 2 * tq + v;
                  if (p < P) acc[p] = accx[nt][2 * hh + v];
                }
            }
          }
        };
        if (!ch) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float4 o4 = xch4[(rw * 4 + nt) * 32 + lane];
            accx[nt][0] += o4.x;
            accx[nt][1] += o4.y;
            accx[nt][2] += o4.z;
            accx[nt][3] += o4.w;
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int jl = jl0 + 8 * hh, j = j0 + jl;
            const float gs = ge[hh] + xr[jl * 2], ds = d[hh] + xr[jl * 2 + 1];
            if (j >= nv || tq) continue;
            const long long o = ((long long)b * S + s0 + j) * H + h;
            if (first) {
              const float tl = ds * u[hh];
              a.colp[o] = -dtj[hh] * gs - tl;
              a.gdtd[o] = gs + ds * ej[hh];
              a.tloc[o] = tl;
            } else {
              a.colp[o] -= dtj[hh] * gs;
              a.gdtd[o] += gs;
            }
          }
          put_gx(0);
#pragma unroll
          for (int nt = 4; nt < 8; ++nt)  // half 0's partials of p >= 32
            xch4[(rw * 4 + nt - 4) * 32 + lane] = make_float4(
                accx[nt][0], accx[nt][1], accx[nt][2], accx[nt][3]);
        }
        __syncthreads();
        if (ch) {
#pragma unroll
          for (int nt = 4; nt < 8; ++nt) {
            const float4 o4 = xch4[(rw * 4 + nt - 4) * 32 + lane];
            accx[nt][0] += o4.x;
            accx[nt][1] += o4.y;
            accx[nt][2] += o4.z;
            accx[nt][3] += o4.w;
          }
          put_gx(4);
        }
      }
    }
    // the group's dG^T of the pass's pairs, rounded once, [j][i] a tile
#pragma unroll 1
    for (int m = 0; m < nk; ++m) {
      T* dst = (T*)a.dgs +
               ((((long long)blockIdx.y * bnc + bc) * nqt + jt) * nqt +
                ip0 + m) * (kTile * kTile);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 s4 = sdg[frag(m, nt)];
        const int col = c0 + nt * 8 + 2 * tq;
        store2<T>(dst + jl0 * kTile + col, s4.x, s4.y);
        store2<T>(dst + (jl0 + 8) * kTile + col, s4.z, s4.w);
      }
    }
  }
  float* pb = a.part_b + (((long long)blockIdx.y * a.B + b) * S + s0) * N;
#pragma unroll
  for (int nt = 0; nt < NH; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + jl0 + 8 * (q >> 1);
      const int n = ch * NH * 8 + nt * 8 + 2 * tq + (q & 1);
      if (j < nv && n < N) pb[(long long)j * N + n] = accb[nt][q];
    }
}

// Pass 3', gB and gC.  Grid (ceil(Q/64), HG, B * nC): a block per (64
// positions t, head group, batch x chunk), t its rows.
template <typename T, int NTN>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_bc_kernel(BwdArgs a) {
  constexpr int NC = NTN * 8;
  constexpr int LDN = ldn<T>(NC), LDP = ld64<T>();
  extern __shared__ float4 smem4[];
  const int Q = a.Q, Qa = (Q + 3) & ~3, nqt = (Q + kTile - 1) / kTile;
  const int Q64 = nqt * kTile;
  float* cumr = reinterpret_cast<float*>(smem4);   // [kRing][Qa]: cum
  float* rpr = cumr + kRing * Qa;       // [kRing][Q64]: row-sum partials
  T* ct = reinterpret_cast<T*>(rpr + kRing * Q64);  // [i][n]: C_t
  T* big = ct + kTile * LDN;            // [kRing][64][LDN]: C_i, B_j, S_c
  T* small = big + kRing * kTile * LDN;  // [kRing][64][LDP]: dG^T, gy_t
  const int t = threadIdx.x, warp = t >> 5;
  const int lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int tt = blockIdx.x, i0 = tt * kTile, il0 = warp * 16 + g;
  const long long bc = blockIdx.z;
  const int b = blockIdx.z / a.nC, c = blockIdx.z % a.nC;
  const int S = a.S, H = a.H, P = a.P, N = a.N;
  const int s0 = c * Q, nv = min(Q, S - s0);
  if (i0 >= nv) return;
  const int ntile = (nv + kTile - 1) / kTile, Pp = round16(P);
  const int h_lo = blockIdx.y * a.hpg, nh = min(H, h_lo + a.hpg) - h_lo;
  const int nbi = ntile - tt, nci = tt + 1, n_items = nbi + nci + nh;
  const Strides& sd = a.sd;
  const T* dg = (const T*)a.dgs + ((long long)blockIdx.y * gridDim.z + bc) *
                                      nqt * nqt * (kTile * kTile);
  const T* cm = (const T*)a.Cm + b * sd.cb + (long long)s0 * sd.cs;
  const T* bm = (const T*)a.Bm + b * sd.bb + (long long)s0 * sd.bs;
  stage_async<NC>(ct, LDN, cm + (long long)i0 * sd.cs, sd.cs, kTile,
                  nv - i0, N, sd.vc);
  // The tile stream: (dG^T of (t, i), C_i) for i >= t, (dG^T of (j, t),
  // B_j) for j <= t, then per head (the row-sum partials, cum, gy_t,
  // S_c).  Item n + 2 is started while item n is used.
  auto issue = [&](int n) {
    const int s = n % kRing;
    T* bs = big + s * kTile * LDN;
    T* ss = small + s * kTile * LDP;
    if (n < nbi) {
      const int it = tt + n;
      stage_async<kTile>(ss, LDP,
                         dg + ((long long)tt * nqt + it) * (kTile * kTile),
                         kTile, kTile, kTile, kTile, true);
      if (it != tt)
        stage_async<NC>(bs, LDN, cm + (long long)it * kTile * sd.cs, sd.cs,
                        kTile, nv - it * kTile, N, sd.vc);
    } else if (n < nbi + nci) {
      const int jt = n - nbi;
      stage_async<kTile>(ss, LDP,
                         dg + ((long long)jt * nqt + tt) * (kTile * kTile),
                         kTile, kTile, kTile, kTile, true);
      stage_async<NC>(bs, LDN, bm + (long long)jt * kTile * sd.bs, sd.bs,
                      kTile, nv - jt * kTile, N, sd.vb);
    } else if (n < n_items) {
      const int h = h_lo + n - nbi - nci;
      const long long row = bc * H + h;
      for (int jt = 0; jt <= tt; ++jt)
        stage_floats_async(rpr + s * Q64 + jt * kTile,
                           a.rowpart +
                               (((long long)jt * gridDim.z + bc) * H + h) *
                                   Q64 + i0,
                           kTile, kTile);
      if (c > 0) {                      // chunk 0 enters with zero state
        stage_floats_async(cumr + s * Qa, a.cum + row * Qa, Qa, Qa);
        stage_async<kTile>(ss, LDP,
                           (const T*)a.gy + b * a.gyb +
                               (long long)(s0 + i0) * a.gys + (long long)h * P,
                           a.gys, kTile, nv - i0, P, a.vgy);
        stage_async<NC>(bs, LDN, (const T*)a.st + row * P * N, N, kTile, P,
                        N, a.vst);
      }
    }
    cp_async_commit();                  // an empty group past the end
  };
  issue(0);
  issue(1);
  int n = 0;
  float accb[NTN][4] = {};              // gB_t's pair terms
  for (; n < nbi; ++n) {
    cp_async_wait<1>();
    __syncthreads();
    issue(n + 2);
    const int s = n % kRing;
    warp_mma<T, NTN, false, true>(accb, small + (s * kTile + warp * 16) * LDP,
                                  LDP,
                                  n == 0 ? ct : big + s * kTile * LDN, LDN,
                                  kTile);
  }
  // the group's gB: the column kernel's carry term, then these
  float* pb = a.part_b + (((long long)blockIdx.y * a.B + b) * S + s0) * N;
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + il0 + 8 * (q >> 1);
      const int nn = nt * 8 + 2 * tq + (q & 1);
      if (i < nv && nn < N) pb[(long long)i * N + nn] += accb[nt][q];
    }
  float accc[NTN][4] = {};              // gC_t
  for (; n < nbi + nci; ++n) {
    cp_async_wait<1>();
    __syncthreads();
    issue(n + 2);
    const int s = n % kRing;
    warp_mma<T, NTN, true, true>(accc, small + s * kTile * LDP + warp * 16,
                                 LDP, big + s * kTile * LDN, LDN, kTile);
  }
  for (; n < n_items; ++n) {
    cp_async_wait<1>();
    __syncthreads();
    issue(n + 2);
    const int s = n % kRing, h = h_lo + n - nbi - nci;
    float rowm[2] = {0.f, 0.f};         // exp(cum_t) C_t . (gy_t S_c)
    if (c > 0) {
      float accz[NTN][4] = {};
      warp_mma<T, NTN, false, true>(accz,
                                    small + (s * kTile + warp * 16) * LDP,
                                    LDP, big + s * kTile * LDN, LDN, Pp);
      const float* cum = cumr + s * Qa;
      float ei[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + il0 + 8 * hh;
        ei[hh] = i < nv ? expf(cum[i]) : 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int il = il0 + 8 * (q >> 1);
          const int nn = nt * 8 + 2 * tq + (q & 1);
          const float z = ei[q >> 1] * accz[nt][q];
          accc[nt][q] += z;
          rowm[q >> 1] += z * to_f32(ct[il * LDN + nn]);
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int il = il0 + 8 * hh, i = i0 + il;
      const float rm = quad_sum(rowm[hh]);
      if (i < nv && tq == 0) {
        float sum = 0.f;                // the column kernel's, j-tile order
        for (int jt = 0; jt <= tt; ++jt) sum += rpr[s * Q64 + jt * kTile + il];
        a.rowp[((long long)b * S + s0 + i) * H + h] = sum + rm;
      }
    }
  }
  float* pc = a.part_c + (((long long)blockIdx.y * a.B + b) * S + s0) * N;
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + il0 + 8 * (q >> 1);
      const int nn = nt * 8 + 2 * tq + (q & 1);
      if (i < nv && nn < N) pc[(long long)i * N + nn] = accc[nt][q];
    }
}
// Pass 4'.  Grid (H, B * nC).  The gradient of cum at position k of the
// chunk is rowp_k + colp_k, plus, at the last position, sum_j tloc_j and
// the carry's exp(L) <R, S> (gl, nb shares); rcs_k is its sum over the
// positions >= k, gdt_k = gdtd_k + A rcs_k and the chunk's share of gA
// is sum_k dt_k rcs_k.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ rowp,
                  const float* __restrict__ colp,
                  const float* __restrict__ gdtd,
                  const float* __restrict__ tloc, const float* __restrict__ gl,
                  int nb, float* __restrict__ gdt, float* __restrict__ ga_part,
                  int S, int H, int Q, int nC) {
  __shared__ float red[4], warp_total[4];
  const int h = blockIdx.x, b = blockIdx.y / nC, c = blockIdx.y % nC;
  const int s0 = c * Q, nv = min(Q, S - s0);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int m = (Q + kThreads - 1) / kThreads, k0 = t * m;
  constexpr int U = QMAX / kThreads;
  const long long base = ((long long)b * S + s0) * H + h;
  float cg[U];
  float tot = 0.f, tl = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = k0 + u;
    const bool ok = u < m && k < nv;
    cg[u] = ok ? rowp[base + (long long)k * H] + colp[base + (long long)k * H]
               : 0.f;
    tot += cg[u];
    tl += ok ? tloc[base + (long long)k * H] : 0.f;
  }
  const long long bch = (long long)blockIdx.y * H + h;
  float carry = 0.f;
  for (int k = 0; k < nb; ++k) carry += gl[bch * nb + k];
  const float last = block_sum(tl, red) + carry;
  // suffix sums of the threads' totals
  float incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl += v;
  }
  if (lane == 0) warp_total[warp] = incl;
  __syncthreads();
  float acc = incl - tot + last;
  for (int w = warp + 1; w < kThreads / 32; ++w) acc += warp_total[w];
  const float a = A[h];
  float ga = 0.f;
#pragma unroll
  for (int u = U - 1; u >= 0; --u) {
    const int k = k0 + u;
    if (u < m && k < nv) {
      acc += cg[u];
      const float d = dt[base + (long long)k * H];
      gdt[base + (long long)k * H] = gdtd[base + (long long)k * H] + a * acc;
      ga = fmaf(d, acc, ga);
    }
  }
  ga = block_sum(ga, red);
  if (t == 0) ga_part[bch] = ga;
}

// Pass 5'.  gB and gC (B, S, N) in T from the HG groups' float32 sums.
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_sum_bc_kernel(const float* __restrict__ part_b,
                      const float* __restrict__ part_c, T* __restrict__ gB,
                      T* __restrict__ gC, long long n, int HG) {
  for (long long e = blockIdx.x * 256ll + threadIdx.x; e < n;
       e += (long long)gridDim.x * 256) {
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < HG; ++k) {
      sb += part_b[k * n + e];
      sc += part_c[k * n + e];
    }
    gB[e] = from_f32<T>(sb);
    gC[e] = from_f32<T>(sc);
  }
}

__global__ void ssd_bwd_sum_a_kernel(const float* __restrict__ ga_part,
                                     float* __restrict__ gA, int H, int nbc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int k = 0; k < nbc; ++k) s += ga_part[(long long)k * H + h];
  gA[h] = s;
}

// The backward's scratch, in floats (each part a multiple of 4, so 16-byte
// aligned), carved in this order: a region that holds the chunk states
// and their gradients (passes 1-2') and then pass 3' on (cum, dt, the
// position sums, the row-sum partials, the dG^T tiles, the head groups'
// gB and gC, gx between passes); R_c and S_c in T; the rest.
struct BwdScratch {
  long long states, region, tcopy, cdecay, fstate, gl, ga;
  long long cum, pos4, rowpart, dgs, parts, gxacc;
  int nb, V;
};

__host__ inline long long up4(long long n) { return (n + 3) & ~3ll; }

__host__ inline BwdScratch bwd_scratch(int B, int S, int H, int P, int N,
                                       int Q, int HG, int esize) {
  BwdScratch w;
  const long long nC = (S + Q - 1) / Q, PN = (long long)P * N;
  const long long bnc = B * nC, nqt = (Q + kTile - 1) / kTile;
  const int KI = esize == 2 ? ki<__nv_bfloat16>() : ki<float>();
  w.V = PN % 4 == 0 ? 4 : 1;
  w.nb = (int)((PN / w.V + 255) / 256);
  w.states = up4(bnc * H * PN);
  w.tcopy = up4((bnc * H * PN * esize + 3) / 4);
  w.cum = bnc * H * ((Q + 3) & ~3);
  w.pos4 = 4 * up4((long long)B * S * H);
  w.rowpart = nqt * bnc * H * nqt * kTile;
  w.dgs = up4(HG * bnc * nqt * nqt * kTile * kTile * esize / 4);
  w.parts = 2 * up4((long long)HG * B * S * N);
  w.gxacc = nqt > KI ? up4((long long)B * S * H * P) : 0;
  const long long post =
      2 * w.cum + w.pos4 + w.rowpart + w.dgs + w.parts + w.gxacc;
  w.region = 2 * w.states > post ? 2 * w.states : post;
  w.cdecay = up4(bnc * H);
  w.fstate = up4((long long)B * H * PN);
  w.gl = up4(bnc * H * w.nb);
  w.ga = up4(bnc * H);
  return w;
}

__host__ inline long long bwd_floats(const BwdScratch& w) {
  return w.region + 2 * w.tcopy + w.cdecay + w.fstate + w.gl + w.ga;
}

template <typename T, int NTN>
cudaError_t bwd_opt_in() {
  constexpr size_t kCol = col_smem<T>(QMAX, NTN * 8);
  constexpr size_t kBc = bc_smem<T>(QMAX, NTN * 8);
  static_assert(kCol <= 227 * 1024 && kBc <= 227 * 1024,
                "backward tiles exceed an SM");
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(ssd_bwd_col_kernel<T, NTN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kCol);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_bc_kernel<T, NTN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kBc);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, int NTN>
int launch_bwd(const BwdArgs& a0, float* ws, const float* g_state,
               float* gdt, float* gA, void* gB, void* gC, int HG,
               cudaStream_t st) {
  const int B = a0.B, S = a0.S, H = a0.H, P = a0.P, N = a0.N, Q = a0.Q;
  const int nC = a0.nC, PN = P * N;
  const int ptiles = (P + kTile - 1) / kTile;
  const int nqt = (Q + kTile - 1) / kTile;
  const BwdScratch w = bwd_scratch(B, S, H, P, N, Q, HG, sizeof(T));
  float* states = ws;                   // passes 1-2'
  float* rstates = states + w.states;
  float* cum = ws;                      // pass 3' on, over the states
  float* dts = cum + w.cum;
  float* pos = dts + w.cum;
  const long long np = w.pos4 / 4;
  float* rowpart = pos + w.pos4;
  float* dgs = rowpart + w.rowpart;
  float* parts = dgs + w.dgs;
  float* gxacc = parts + w.parts;
  T* rt = reinterpret_cast<T*>(ws + w.region);
  T* stt = reinterpret_cast<T*>(ws + w.region + w.tcopy);
  float* cdecay = ws + w.region + 2 * w.tcopy;
  float* fstate = cdecay + w.cdecay;
  float* gl = fstate + w.fstate;
  float* ga_part = gl + w.gl;
  BwdArgs a = a0;
  a.rt = rt;
  a.st = stt;
  a.cum = cum;
  a.dts = dts;
  a.rowp = pos;
  a.colp = pos + np;
  a.gdtd = pos + 2 * np;
  a.tloc = pos + 3 * np;
  a.rowpart = rowpart;
  a.dgs = dgs;
  a.part_b = parts;
  a.part_c = parts + w.parts / 2;
  a.gxacc = gxacc;
  a.vst = (int)((N * sizeof(T)) % 16 == 0);
  cudaError_t err = bwd_opt_in<T, NTN>();
  if (err != cudaSuccess) return (int)err;
  const dim3 g1(ptiles * ((N + kTile - 1) / kTile), H, B * nC);
  // passes 1 and 2 of the forward: the state entering each chunk
  ssd_chunk_state_kernel<T><<<g1, kThreads, 0, st>>>(
      (const T*)a.x, a.dt, a.A, (const T*)a.Bm, states, cdecay, S, H, P, N,
      Q, nC, a.sd);
  if (w.V == 4)
    ssd_state_pass_kernel<4><<<dim3(w.nb, H, B), 256, 0, st>>>(
        states, cdecay, fstate, H, PN, nC);
  else
    ssd_state_pass_kernel<1><<<dim3(w.nb, H, B), 256, 0, st>>>(
        states, cdecay, fstate, H, PN, nC);
  // 1': D_c, gy playing x and C playing B
  Strides g = a.sd;
  g.xb = a.gyb;
  g.xs = a.gys;
  g.vx = a.vgy;
  g.bb = a.sd.cb;
  g.bs = a.sd.cs;
  g.vb = a.sd.vc;
  ssd_chunk_state_kernel<T, true><<<g1, kThreads, 0, st>>>(
      (const T*)a.gy, a.dt, a.A, (const T*)a.Cm, rstates, cdecay, S, H, P, N,
      Q, nC, g);
  // 2': the state gradients, last chunk first; R_c and S_c in T
  if (w.V == 4)
    ssd_state_grad_kernel<T, 4><<<dim3(w.nb, H, B), 256, 0, st>>>(
        rstates, states, cdecay, g_state, rt, stt, gl, H, PN, nC);
  else
    ssd_state_grad_kernel<T, 1><<<dim3(w.nb, H, B), 256, 0, st>>>(
        rstates, states, cdecay, g_state, rt, stt, gl, H, PN, nC);
  // 3': cum and dt rows, the pairs' columns, then gB and gC by tile
  ssd_bwd_cum_kernel<<<dim3(H, B * nC), kThreads, 0, st>>>(
      a.dt, a.A, cum, dts, S, H, Q, nC);
  ssd_bwd_col_kernel<T, NTN><<<dim3(B * nC, HG, nqt), kColThreads,
                               col_smem<T>(Q, NTN * 8), st>>>(a);
  ssd_bwd_bc_kernel<T, NTN><<<dim3(nqt, HG, B * nC), kThreads,
                              bc_smem<T>(Q, NTN * 8), st>>>(a);
  // 4': gdt and the chunks' shares of gA
  ssd_bwd_dt_kernel<<<dim3(H, B * nC), kThreads, 0, st>>>(
      a.dt, a.A, a.rowp, a.colp, a.gdtd, a.tloc, gl, w.nb, gdt, ga_part, S,
      H, Q, nC);
  // 5': the head groups' gB and gC, the shares of gA
  const long long nbsn = (long long)B * S * N;
  const long long nblk = (nbsn + 255) / 256;
  ssd_bwd_sum_bc_kernel<T><<<(int)(nblk < 4096 ? nblk : 4096), 256, 0, st>>>(
      a.part_b, a.part_c, (T*)gB, (T*)gC, nbsn, HG);
  ssd_bwd_sum_a_kernel<<<(H + 127) / 128, 128, 0, st>>>(ga_part, gA, H,
                                                        B * nC);
  return (int)cudaGetLastError();
}

// 1 when p and the two strides (elements of es bytes) keep 16-byte rows.
int aligned16(const void* p, long long s1, long long s2, long long es) {
  return (int)((uintptr_t)p % 16 == 0 && (s1 * es) % 16 == 0 &&
               (s2 * es) % 16 == 0);
}

}  // namespace

extern "C" int ssd_scan_qmax() { return QMAX; }
extern "C" int ssd_scan_nmax() { return NMAX; }

// dtype: 0 = float32 x/Bm/Cm/y, 1 = bfloat16.  dt, A, state and the
// scratch are float32: states (B, ceil(S/Q), H, P, N), cdecay
// (B, ceil(S/Q), H).  Strides are in elements.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, void* states, void* cdecay,
                               int dtype, int B, int S, int H, int P, int N,
                               int Q, long long sxb, long long sxs,
                               long long sbb, long long sbs, long long scb,
                               long long scs, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || N > NMAX || Q < 1 ||
      Q > QMAX || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long es = dtype == 0 ? 4 : 2;
  const Strides sd{sxb, sxs, sbb, sbs, scb, scs,
                   aligned16(x, sxs, sxb, es) & (int)((P * es) % 16 == 0),
                   aligned16(Bm, sbs, sbb, es), aligned16(Cm, scs, scb, es),
                   (int)((P * es) % 16 == 0)};   // y: contiguous, fresh
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, (const float*)dt, (const float*)A, Bm, Cm, y,
                         (float*)state, (float*)states, (float*)cdecay, B, S,
                         H, P, N, Q, sd, st);
  return launch<__nv_bfloat16>(x, (const float*)dt, (const float*)A, Bm, Cm,
                               y, (float*)state, (float*)states,
                               (float*)cdecay, B, S, H, P, N, Q, sd, st);
}

extern "C" int ssd_scan_bwd_pmax() { return kPMaxBwd; }
extern "C" int ssd_scan_bwd_nmax() { return kNMaxBwd; }

// Floats of scratch the backward needs for these shapes, dtype (as
// ssd_scan_bwd_launch's) and HG head groups (the caller allocates them,
// 16-byte aligned).
extern "C" long long ssd_scan_bwd_workspace(int B, int S, int H, int P,
                                            int N, int Q, int HG,
                                            int dtype) {
  return bwd_floats(bwd_scratch(B, S, H, P, N, Q, HG, dtype == 0 ? 4 : 2));
}

// The gradients of ssd_scan_launch's inputs.  dtype, shapes and the
// strides of x, Bm and Cm as there; gy (the gradient of y, in x's dtype)
// read through its batch and token strides, a token (H, P) contiguous;
// g_state (B, H, P, N) float32 contiguous or null (zero).  Writes gx
// (B, S, H, P) and gB, gC (B, S, N) in x's dtype, gdt (B, S, H) and gA
// (H,) float32, all contiguous, using ws (ssd_scan_bwd_workspace floats).
// HG head groups share gB and gC's sums over heads: the blocks of pass 3'
// are ceil(Q/64) x HG x B ceil(S/Q).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* gy, const void* g_state, void* gx, void* gdt,
    void* gA, void* gB, void* gC, void* ws, int dtype, int B, int S, int H,
    int P, int N, int Q, int HG, long long sxb, long long sxs, long long sbb,
    long long sbs, long long scb, long long scs, long long gyb,
    long long gys, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kPMaxBwd || N < 1 ||
      N > kNMaxBwd || Q < 1 || Q > QMAX || HG < 1 || HG > H ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int nC = (S + Q - 1) / Q, hpg = (H + HG - 1) / HG;
  if ((HG - 1) * hpg >= H || (long long)B * nC > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long es = dtype == 0 ? 4 : 2;
  const int pvec = (int)((P * es) % 16 == 0);
  BwdArgs a{};
  a.x = x;
  a.Bm = Bm;
  a.Cm = Cm;
  a.gy = gy;
  a.dt = (const float*)dt;
  a.A = (const float*)A;
  a.gx = gx;
  a.B = B;
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.Q = Q;
  a.nC = nC;
  a.hpg = hpg;
  a.sd = Strides{sxb, sxs, sbb, sbs, scb, scs,
                 aligned16(x, sxs, sxb, es) & pvec,
                 aligned16(Bm, sbs, sbb, es), aligned16(Cm, scs, scb, es),
                 pvec};
  a.gyb = gyb;
  a.gys = gys;
  a.vgy = aligned16(gy, gys, gyb, es) & pvec;
  cudaStream_t st = (cudaStream_t)stream;
  const float* gs = (const float*)g_state;
  float* w = (float*)ws;
  if (dtype == 0)
    return N > 64 ? launch_bwd<float, 16>(a, w, gs, (float*)gdt, (float*)gA,
                                          gB, gC, HG, st)
                  : launch_bwd<float, 8>(a, w, gs, (float*)gdt, (float*)gA,
                                         gB, gC, HG, st);
  return N > 64 ? launch_bwd<__nv_bfloat16, 16>(a, w, gs, (float*)gdt,
                                                (float*)gA, gB, gC, HG, st)
                : launch_bwd<__nv_bfloat16, 8>(a, w, gs, (float*)gdt,
                                               (float*)gA, gB, gC, HG, st);
}
