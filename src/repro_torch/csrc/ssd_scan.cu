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

// Pass 1.  Grid (ceil(P/64) * ceil(N/64), H, B * nC).
template <typename T>
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
  chunk_cumsum(dt + (long long)b * S * H + h, H, s0, nv, Q, A[h], dts, cum);
  const float clast = cum[Q - 1];       // = cum[nv - 1]: dt 0 after
  for (int j = t; j < nv; j += kThreads) dts[j] *= expf(clast - cum[j]);
  if (blockIdx.x == 0 && t == 0) cdecay[(long long)blockIdx.z * H + h] = clast;
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
  auto aligned = [es](const void* p, long long s1, long long s2) {
    return (int)((uintptr_t)p % 16 == 0 && (s1 * es) % 16 == 0 &&
                 (s2 * es) % 16 == 0);
  };
  const Strides sd{sxb, sxs, sbb, sbs, scb, scs,
                   aligned(x, sxs, sxb) & (int)((P * es) % 16 == 0),
                   aligned(Bm, sbs, sbb), aligned(Cm, scs, scb),
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
