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
// operations, takes 0.012 ms beside the tensor cores.  This design does
// more: C.B^T in every head's loop of both pass-3 kernels, dG^T C and
// dG B per head, mma.sync tiles, so it runs far from that bound; a G
// shared across a group's heads, dG summed over the group before its
// products, wgmma and TMA are later work.
//
// Nothing is saved by the forward: passes 1-2 run again for the
// state entering each chunk, S_c.  Then, with R_c the gradient of the
// state leaving chunk c (R of the last chunk = the final state's
// gradient, or zero), L_c = cum_last and u_j = exp(L_c - cum_j) dt_j:
//   1'. D_c = sum_i exp(cum_i) gy_i C_i^T per (batch, chunk > 0, head):
//       pass 1 with kGrad.
//   2'. R_{c-1} = exp(L_c) R_c + D_c from the last chunk to the first, in
//       place of D (ssd_state_grad_kernel), and each block's share of
//       exp(L_c) <R_c, S_c>, the gradient of L_c through the carry.
//   3'. ssd_bwd_col_kernel, a block per (64 positions j, head group,
//       batch x chunk), with j as its rows: G^T = B_j C_i^T and
//       dW^T = x_j gy_i^T for each tile i >= j, W = G E dt_j and
//       dG = dW E dt_j (E = exp(cum_i - cum_j), formed only for j <= i),
//       gx_j = u_j (B_j R_c^T) + W^T gy, gB_j += u_j (x_j R_c) + dG^T C
//       (summed over the group's heads), and per position the column
//       sums of dW G E.  ssd_bwd_row_kernel, a block per (64 positions i,
//       head group, batch x chunk), with i as its rows: the same G and
//       dW, gC_i += exp(cum_i) gy_i S_c + dG B_j, and the row sums of
//       dW G E dt_j.
//   4'. ssd_bwd_dt_kernel, a block per (head, batch x chunk): the
//       gradient of cum at each position from the row and column sums,
//       its reverse cumsum within the chunk, then gdt and the chunk's
//       share of gA.
//   5'. ssd_bwd_sum_bc_kernel sums the head groups' float32 gB and gC in
//       group order and casts them; ssd_bwd_sum_a_kernel sums gA's shares
//       in (batch, chunk) order.  No atomics: a call's result does not
//       change from run to run.
// Every product is the forward's warp_mma.  For bfloat16 inputs the
// operands formed in float32 (W, dG, the carried states S_c and R_c) are
// rounded to bfloat16 for the product, as the forward rounds W and S_c,
// and pass 1' splits gy o exp(cum) into head and remainder as pass 1
// does; gdt and gA are float32 throughout.  The kernel differentiates its
// own forward (C.B^T in float32, W rounded only as a product's operand),
// not the plain version's bfloat16 Gram matrix.  P <= 64 and N <= 128:
// the backward keeps a 64 x P and a 64 x N accumulator a block.

constexpr int kPMaxBwd = 64;
constexpr int kNMaxBwd = 128;

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

// Pass 2'.  Grid (ceil(P*N/256/V), H, B).  rstates holds D_c for c > 0 on
// entry and R_c (the gradient of the state leaving chunk c) on exit;
// gl[(b nC + c) H + h][blockIdx.x] = this block's share of
// exp(L_c) <R_c, S_c>.  g_state may be null (zero).
template <int V>
__global__ void __launch_bounds__(256)
ssd_state_grad_kernel(float* __restrict__ rstates,
                      const float* __restrict__ states,
                      const float* __restrict__ cdecay,
                      const float* __restrict__ g_state,
                      float* __restrict__ gl, int H, int PN, int nC) {
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
      float* slot = rstates + bch * PN + e;
      const float* sc = states + bch * PN + e;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float dc = c > 0 ? slot[v] : 0.f;
        slot[v] = r[v];
        dot = fmaf(r[v], sc[v], dot);
        r[v] = fmaf(d, r[v], dc);
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

// Leading dimensions of the backward's tiles: NC = 64 or 128 columns of
// B, C and the states; 64 of x, gy, W and dG.
template <typename T>
__host__ __device__ constexpr int ldn(int NC) { return NC + pad<T>(); }
template <typename T>
__host__ __device__ constexpr int ld64() { return kTile + pad<T>(); }

template <typename T>
__host__ __device__ constexpr size_t col_smem(int Q, int NC) {
  return 2 * sizeof(float) * ((Q + 3) & ~3) +
         sizeof(T) * kTile * (2 * ldn<T>(NC) + 4 * ld64<T>()) +
         2 * sizeof(float) * kTile;
}
template <typename T>
__host__ __device__ constexpr size_t row_smem(int Q, int NC) {
  return 2 * sizeof(float) * ((Q + 3) & ~3) +
         sizeof(T) * kTile * (2 * ldn<T>(NC) + 3 * ld64<T>()) +
         2 * sizeof(float) * kTile;
}

struct BwdArgs {
  const void *x, *Bm, *Cm, *gy;
  const float *dt, *A, *states, *rstates;
  void* gx;
  float *part_b, *part_c;               // (HG, B, S, N) float32
  float *rowp, *colp, *gdtd, *tloc;     // (B, S, H) float32
  int B, S, H, P, N, Q, nC, hpg;
  Strides sd;                           // x, Bm, Cm as in the forward
  long long gyb, gys;
  int vgy;
};

// Pass 3', columns.  Grid (ceil(Q/64), HG, B * nC).
template <typename T, int NTN>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_col_kernel(BwdArgs a) {
  constexpr int NC = NTN * 8;
  constexpr int LDN = ldn<T>(NC), LDP = ld64<T>();
  extern __shared__ float4 smem4[];
  const int Qa = (a.Q + 3) & ~3;
  float* dts = reinterpret_cast<float*>(smem4);
  float* cum = dts + Qa;
  T* bj = reinterpret_cast<T*>(cum + Qa);  // [j][n]: B_j
  T* ci = bj + kTile * LDN;             // [p][n]: R_c, then [i][n]: C_i
  T* xj = ci + kTile * LDN;             // [j][p]: x_j
  T* gyi = xj + kTile * LDP;            // [i][p]: gy_i
  T* wt = gyi + kTile * LDP;            // [j][i]: W^T
  T* dgt = wt + kTile * LDP;            // [j][i]: dG^T
  float* fi = reinterpret_cast<float*>(dgt + kTile * LDP);  // [i]
  float* fj = fi + kTile;                                   // [j]
  const int t = threadIdx.x, warp = t >> 5;
  const int lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * kTile;
  const int b = blockIdx.z / a.nC, c = blockIdx.z % a.nC;
  const int S = a.S, H = a.H, P = a.P, N = a.N;
  const int s0 = c * a.Q, nv = min(a.Q, S - s0);
  if (j0 >= nv) return;
  const int Np = round16(N), Pp = round16(P);
  const int h_lo = blockIdx.y * a.hpg, h_hi = min(H, h_lo + a.hpg);
  const Strides& sd = a.sd;
  auto copy_to = [](T* dst, int ld) {
    return [dst, ld](int r, int k, uint4 u) {
      *reinterpret_cast<uint4*>(dst + r * ld + k) = u;
    };
  };
  stage((const T*)a.Bm + b * sd.bb + (long long)(s0 + j0) * sd.bs, sd.bs,
        kTile, NC, nv - j0, N, sd.vb, copy_to(bj, LDN));
  float accb[NTN][4] = {};              // gB_j over the group's heads
  for (int h = h_lo; h < h_hi; ++h) {
    __syncthreads();                    // last head's reads of smem done
    chunk_cumsum(a.dt + (long long)b * S * H + h, H, s0, nv, a.Q, a.A[h],
                 dts, cum);
    const float L = cum[a.Q - 1];
    stage((const T*)a.x + b * sd.xb + (long long)(s0 + j0) * sd.xs +
              (long long)h * P, sd.xs, kTile, kTile, nv - j0, P, sd.vx,
          copy_to(xj, LDP));
    const float* rc = a.rstates + ((long long)blockIdx.z * H + h) * P * N;
    stage(rc, N, kTile, NC, P, N, (N & 3) == 0, [&](int r, int k, uint4 u) {
      float v[4];
      widen<float>(u, v);
      store_as<T, 4>(ci + r * LDN + k, v);
    });
    __syncthreads();
    // the carry's terms: gx_j = u_j B_j R^T, V_j = x_j R, gB_j += u_j V_j
    float u[2], ej[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = j0 + warp * 16 + g + 8 * hh;
      ej[hh] = j < nv ? expf(L - cum[j]) : 0.f;
      u[hh] = ej[hh] * (j < nv ? dts[j] : 0.f);
    }
    float accx[8][4] = {};
    warp_mma<T, 8, false, false>(accx, bj + warp * 16 * LDN, LDN, ci, LDN,
                                 Np);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) accx[nt][q] *= u[q >> 1];
    float du[2] = {0.f, 0.f};
    {
      float accv[NTN][4] = {};
      warp_mma<T, NTN, false, true>(accv, xj + warp * 16 * LDP, LDP, ci,
                                    LDN, Pp);
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jl = warp * 16 + g + 8 * (q >> 1);
          const int n = nt * 8 + 2 * tq + (q & 1);
          du[q >> 1] += accv[nt][q] * to_f32(bj[jl * LDN + n]);
          accb[nt][q] += u[q >> 1] * accv[nt][q];
        }
    }
    float cge[2] = {0.f, 0.f};          // sum over i of dW G E
    for (int i0 = j0; i0 < nv; i0 += kTile) {
      __syncthreads();                  // ci, gyi, wt, dgt free
      stage((const T*)a.Cm + b * sd.cb + (long long)(s0 + i0) * sd.cs, sd.cs,
            kTile, NC, nv - i0, N, sd.vc, copy_to(ci, LDN));
      stage((const T*)a.gy + b * a.gyb + (long long)(s0 + i0) * a.gys +
                (long long)h * P, a.gys, kTile, kTile, nv - i0, P, a.vgy,
            copy_to(gyi, LDP));
      const bool diag = i0 == j0;
      const int jr = j0 + kTile - 1;    // below every i when i0 > j0
      if (!diag) {
        if (t < kTile)
          fi[t] = i0 + t < nv ? expf(cum[i0 + t] - cum[jr]) : 0.f;
        else
          fj[t - kTile] = expf(cum[jr] - cum[j0 + t - kTile]);
      }
      __syncthreads();
      float accg[8][4] = {}, accd[8][4] = {};
      warp_mma<T, 8, false, false>(accg, bj + warp * 16 * LDN, LDN, ci, LDN,
                                   Np);
      warp_mma<T, 8, false, false>(accd, xj + warp * 16 * LDP, LDP, gyi,
                                   LDP, Pp);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int jl = warp * 16 + g + 8 * hh, j = j0 + jl;
          float w[2], dg[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int il = nt * 8 + 2 * tq + v, i = i0 + il;
            float e;
            if (diag)
              e = j <= i && i < nv ? expf(cum[i] - cum[j]) : 0.f;
            else
              e = fi[il] * fj[jl];
            const float gv = accg[nt][2 * hh + v], dw = accd[nt][2 * hh + v];
            const float dtj = j < nv ? dts[j] : 0.f;
            w[v] = gv * e * dtj;
            dg[v] = dw * e * dtj;
            cge[hh] += dw * gv * e;
          }
          store2<T>(wt + jl * LDP + nt * 8 + 2 * tq, w[0], w[1]);
          store2<T>(dgt + jl * LDP + nt * 8 + 2 * tq, dg[0], dg[1]);
        }
      __syncwarp();
      warp_mma<T, 8, false, true>(accx, wt + warp * 16 * LDP, LDP, gyi, LDP,
                                  kTile);
      warp_mma<T, NTN, false, true>(accb, dgt + warp * 16 * LDP, LDP, ci,
                                    LDN, kTile);
    }
    // this head's gx and per-position sums
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = j0 + warp * 16 + g + 8 * hh;
      const float ge = quad_sum(cge[hh]), d = quad_sum(du[hh]);
      if (j < nv && tq == 0) {
        const long long o = ((long long)b * S + s0 + j) * H + h;
        const float tl = d * u[hh];
        a.colp[o] = -dts[j] * ge - tl;
        a.gdtd[o] = ge + d * ej[hh];
        a.tloc[o] = tl;
      }
      if (j < nv) {
        T* gxr = (T*)a.gx + (((long long)b * S + s0 + j) * H + h) * P;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int p = nt * 8 + 2 * tq;
          if (p + 1 < P && (P & 1) == 0) {
            store2<T>(gxr + p, accx[nt][2 * hh], accx[nt][2 * hh + 1]);
          } else {
            if (p < P) gxr[p] = from_f32<T>(accx[nt][2 * hh]);
            if (p + 1 < P) gxr[p + 1] = from_f32<T>(accx[nt][2 * hh + 1]);
          }
        }
      }
    }
  }
  float* pb = a.part_b + (((long long)blockIdx.y * a.B + b) * S + s0) * N;
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + warp * 16 + g + 8 * (q >> 1);
      const int n = nt * 8 + 2 * tq + (q & 1);
      if (j < nv && n < N) pb[(long long)j * N + n] = accb[nt][q];
    }
}

// Pass 3', rows.  Grid (ceil(Q/64), HG, B * nC).
template <typename T, int NTN>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_row_kernel(BwdArgs a) {
  constexpr int NC = NTN * 8;
  constexpr int LDN = ldn<T>(NC), LDP = ld64<T>();
  extern __shared__ float4 smem4[];
  const int Qa = (a.Q + 3) & ~3;
  float* dts = reinterpret_cast<float*>(smem4);
  float* cum = dts + Qa;
  T* ci = reinterpret_cast<T*>(cum + Qa);  // [i][n]: C_i
  T* bj = ci + kTile * LDN;             // [p][n]: S_c, then [j][n]: B_j
  T* gyi = bj + kTile * LDN;            // [i][p]: gy_i
  T* xj = gyi + kTile * LDP;            // [j][p]: x_j
  T* dg = xj + kTile * LDP;             // [i][j]: dG
  float* fi = reinterpret_cast<float*>(dg + kTile * LDP);  // [i]
  float* fj = fi + kTile;                                  // [j]
  const int t = threadIdx.x, warp = t >> 5;
  const int lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int i0 = blockIdx.x * kTile;
  const int b = blockIdx.z / a.nC, c = blockIdx.z % a.nC;
  const int S = a.S, H = a.H, P = a.P, N = a.N;
  const int s0 = c * a.Q, nv = min(a.Q, S - s0);
  if (i0 >= nv) return;
  const int Np = round16(N), Pp = round16(P);
  const int h_lo = blockIdx.y * a.hpg, h_hi = min(H, h_lo + a.hpg);
  const Strides& sd = a.sd;
  auto copy_to = [](T* dst, int ld) {
    return [dst, ld](int r, int k, uint4 u) {
      *reinterpret_cast<uint4*>(dst + r * ld + k) = u;
    };
  };
  stage((const T*)a.Cm + b * sd.cb + (long long)(s0 + i0) * sd.cs, sd.cs,
        kTile, NC, nv - i0, N, sd.vc, copy_to(ci, LDN));
  float accc[NTN][4] = {};              // gC_i over the group's heads
  for (int h = h_lo; h < h_hi; ++h) {
    __syncthreads();
    chunk_cumsum(a.dt + (long long)b * S * H + h, H, s0, nv, a.Q, a.A[h],
                 dts, cum);
    stage((const T*)a.gy + b * a.gyb + (long long)(s0 + i0) * a.gys +
              (long long)h * P, a.gys, kTile, kTile, nv - i0, P, a.vgy,
          copy_to(gyi, LDP));
    if (c > 0) {
      const float* st = a.states + ((long long)blockIdx.z * H + h) * P * N;
      stage(st, N, kTile, NC, P, N, (N & 3) == 0, [&](int r, int k, uint4 u) {
        float v[4];
        widen<float>(u, v);
        store_as<T, 4>(bj + r * LDN + k, v);
      });
    }
    __syncthreads();
    float rowm[2] = {0.f, 0.f};         // sum over j of dW G E dt_j, then
    if (c > 0) {                        // + exp(cum_i) C_i . (gy_i S_c)
      float accz[NTN][4] = {};
      warp_mma<T, NTN, false, true>(accz, gyi + warp * 16 * LDP, LDP, bj,
                                    LDN, Pp);
      float ei[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + warp * 16 + g + 8 * hh;
        ei[hh] = i < nv ? expf(cum[i]) : 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int il = warp * 16 + g + 8 * (q >> 1);
          const int n = nt * 8 + 2 * tq + (q & 1);
          const float z = ei[q >> 1] * accz[nt][q];
          accc[nt][q] += z;
          rowm[q >> 1] += z * to_f32(ci[il * LDN + n]);
        }
    }
    for (int j0 = 0; j0 <= i0; j0 += kTile) {
      __syncthreads();                  // bj, xj, dg free
      stage((const T*)a.Bm + b * sd.bb + (long long)(s0 + j0) * sd.bs, sd.bs,
            kTile, NC, nv - j0, N, sd.vb, copy_to(bj, LDN));
      stage((const T*)a.x + b * sd.xb + (long long)(s0 + j0) * sd.xs +
                (long long)h * P, sd.xs, kTile, kTile, nv - j0, P, sd.vx,
            copy_to(xj, LDP));
      const bool diag = i0 == j0;
      const int jr = j0 + kTile - 1;    // below every i when j0 < i0
      if (!diag) {
        if (t < kTile)
          fi[t] = i0 + t < nv ? expf(cum[i0 + t] - cum[jr]) : 0.f;
        else
          fj[t - kTile] = expf(cum[jr] - cum[j0 + t - kTile]);
      }
      __syncthreads();
      float accg[8][4] = {}, accd[8][4] = {};
      warp_mma<T, 8, false, false>(accg, ci + warp * 16 * LDN, LDN, bj, LDN,
                                   Np);
      warp_mma<T, 8, false, false>(accd, gyi + warp * 16 * LDP, LDP, xj,
                                   LDP, Pp);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int il = warp * 16 + g + 8 * hh, i = i0 + il;
          float d2[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int jl = nt * 8 + 2 * tq + v, j = j0 + jl;
            float e;
            if (diag)
              e = j <= i && i < nv ? expf(cum[i] - cum[j]) : 0.f;
            else
              e = fi[il] * fj[jl];
            const float dtj = j < nv ? dts[j] : 0.f;
            const float gv = accg[nt][2 * hh + v], dw = accd[nt][2 * hh + v];
            d2[v] = dw * e * dtj;
            rowm[hh] += dw * gv * e * dtj;
          }
          store2<T>(dg + il * LDP + nt * 8 + 2 * tq, d2[0], d2[1]);
        }
      __syncwarp();
      warp_mma<T, NTN, false, true>(accc, dg + warp * 16 * LDP, LDP, bj, LDN,
                                    kTile);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + warp * 16 + g + 8 * hh;
      const float rm = quad_sum(rowm[hh]);
      if (i < nv && tq == 0)
        a.rowp[((long long)b * S + s0 + i) * H + h] = rm;
    }
  }
  float* pc = a.part_c + (((long long)blockIdx.y * a.B + b) * S + s0) * N;
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + warp * 16 + g + 8 * (q >> 1);
      const int n = nt * 8 + 2 * tq + (q & 1);
      if (i < nv && n < N) pc[(long long)i * N + n] = accc[nt][q];
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

// The backward's scratch, in floats, carved in this order (each part a
// multiple of 4 floats, so 16-byte aligned).
struct BwdScratch {
  long long states, cdecay, fstate, rstates, gl, pos4, ga, parts;
  int nb, V;
};

__host__ inline long long up4(long long n) { return (n + 3) & ~3ll; }

__host__ inline BwdScratch bwd_scratch(int B, int S, int H, int P, int N,
                                       int Q, int HG) {
  BwdScratch w;
  const long long nC = (S + Q - 1) / Q, PN = (long long)P * N;
  w.V = PN % 4 == 0 ? 4 : 1;
  w.nb = (int)((PN / w.V + 255) / 256);
  w.states = up4(B * nC * H * PN);
  w.cdecay = up4(B * nC * H);
  w.fstate = up4((long long)B * H * PN);
  w.rstates = w.states;
  w.gl = up4(B * nC * H * w.nb);
  w.pos4 = 4 * up4((long long)B * S * H);
  w.ga = up4(B * nC * H);
  w.parts = 2 * up4((long long)HG * B * S * N);
  return w;
}

template <typename T, int NTN>
cudaError_t bwd_opt_in() {
  constexpr size_t kCol = col_smem<T>(QMAX, NTN * 8);
  constexpr size_t kRow = row_smem<T>(QMAX, NTN * 8);
  static_assert(kCol <= 227 * 1024 && kRow <= 227 * 1024,
                "backward tiles exceed an SM");
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(ssd_bwd_col_kernel<T, NTN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kCol);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_row_kernel<T, NTN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kRow);
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
  const BwdScratch w = bwd_scratch(B, S, H, P, N, Q, HG);
  float* states = ws;
  float* cdecay = states + w.states;
  float* fstate = cdecay + w.cdecay;
  float* rstates = fstate + w.fstate;
  float* gl = rstates + w.rstates;
  float* pos = gl + w.gl;
  const long long np = w.pos4 / 4;
  float* ga_part = pos + w.pos4;
  float* parts = ga_part + w.ga;
  BwdArgs a = a0;
  a.states = states;
  a.rstates = rstates;
  a.rowp = pos;
  a.colp = pos + np;
  a.gdtd = pos + 2 * np;
  a.tloc = pos + 3 * np;
  a.part_b = parts;
  a.part_c = parts + w.parts / 2;
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
  // 2': the state gradients, last chunk first
  if (w.V == 4)
    ssd_state_grad_kernel<4><<<dim3(w.nb, H, B), 256, 0, st>>>(
        rstates, states, cdecay, g_state, gl, H, PN, nC);
  else
    ssd_state_grad_kernel<1><<<dim3(w.nb, H, B), 256, 0, st>>>(
        rstates, states, cdecay, g_state, gl, H, PN, nC);
  // 3': columns and rows of each chunk's pairs
  const dim3 g3(nqt, HG, B * nC);
  ssd_bwd_col_kernel<T, NTN><<<g3, kThreads, col_smem<T>(Q, NTN * 8), st>>>(a);
  ssd_bwd_row_kernel<T, NTN><<<g3, kThreads, row_smem<T>(Q, NTN * 8), st>>>(a);
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

// Floats of scratch the backward needs for these shapes and HG head
// groups (the caller allocates them, 16-byte aligned).
extern "C" long long ssd_scan_bwd_workspace(int B, int S, int H, int P,
                                            int N, int Q, int HG) {
  const BwdScratch w = bwd_scratch(B, S, H, P, N, Q, HG);
  return w.states + w.cdecay + w.fstate + w.rstates + w.gl + w.pos4 + w.ga +
         w.parts;
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
