// Flash-decode attention for NVIDIA Hopper (sm_90a): one query token per
// (batch, kv-head) group of G query heads against a KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py `decode_attention_pallas` (body `_decode_kernel`).  It
// computes what repro_torch.kernels.decode_attention.ref.
// decode_attention_ref computes: scores q.k * hd^-0.5 in float32 over the
// cache positions t <= pos (and t > pos - window when a window is set), a
// softmax, and the probability-weighted sum of the values, accumulated in
// float32 and written in q's type.  Masked positions contribute exactly
// zero there (exp(-2^30 - m) underflows), so the kernel skips them.  When
// no position is valid the reference's softmax is uniform over all S
// positions; the host then passes `uniform`, and every score is 0.
//
// What bounds it on the H100: bytes.  Each (batch, kv-head) reads the
// keys and values of its valid positions once (OLMoE serving: 4 x 16
// heads x 1,055 positions x 128 elements x 2 B x 2 = 34.6 MB a layer,
// ~10 us at 3.35 TB/s) and does 4 G hd flops per position, far below the
// bf16 rate.  So the design keeps enough bytes in flight on every SM:
//
//   1. Split-KV (flash-decoding).  The valid positions lo..hi are cut into
//      `splits` (at most 8) contiguous ranges of `split_len`; the wrapper
//      picks them so that the grid (splits, K, B) holds ~4 blocks an SM:
//      512 blocks of <= 132 positions at the serving shape, against 64
//      blocks of 1,055 before.  The splits of one (batch, kv-head) form a
//      thread-block cluster.  Each block of 4 warps merges its warps'
//      online-softmax states (running max m, normaliser l, float32
//      acc[hd]) in shared memory; then block 0 of the cluster reads the
//      other blocks' partials through distributed shared memory and
//      merges them by log-sum-exp.  No split is empty: the plan covers
//      only the valid positions.  No scratch in device memory, no second
//      pass.
//   2. 16-byte vector loads.  A lane holds VEC consecutive elements of a
//      row (8 bf16 or 4 float32), LPR lanes cover a row, so a warp load
//      instruction covers 32 / LPR rows (2 at hd 128 in bf16).  A head
//      dimension whose rows are not 16-byte multiples (or an unaligned
//      pointer) takes the scalar layout (VEC 1, 32 lanes a row).
//   3. Tiles, not positions.  A warp issues the key and value loads of 2
//      load steps (2 x 32/LPR rows) before it uses any, then computes the
//      tile's scores, takes one max over the tile, rescales once, and
//      accumulates.  (Tiles of 4 or 8 load steps, and 2 or 8 warps a
//      block, were slower on the H100 at the serving shape: the split's
//      last tile is then mostly empty.)  The softmax runs in base 2 (q
//      is pre-scaled by hd^-0.5 log2 e), so each weight is one exp2f.
//      Keys and values are read once, with streaming loads (__ldcs).
//
// Each K/V row loaded serves all G query rows of its group (up to 8 at
// once; a larger G walks the rows in groups of 8 and re-reads the cache).
//
// Partial mode (decode_attention_partial_launch): the same kernel over one
// block of a cache whose sequence is cut over several ranks.  Where block
// 0 of the cluster (or the only block) would write the normalised output
// in q's type, it writes three float32 results instead, for the caller's
// cross-rank merge: o = acc / l, m the row max of the scaled scores (in
// base e) and l the sum of exp(score - m).  A block that holds no valid
// position runs the uniform case (every score 0 over all S positions),
// which gives l = S and o the mean of the values, and reports m = -2^30,
// the reference's mask value: every one of its scores is masked, so it
// weighs nothing beside a block that holds a valid position.  Rounding
// to q's type happens once, after the merge.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define HDMAX 256      // head dimension: up to 8 elements a lane
#define MAX_SPLITS 8   // splits of one (batch, kv-head): a portable cluster

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1073741824.f;   // -2^30, the reference's mask

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch does
}

// A lane's load of VEC consecutive elements, and its widening to float32.
template <typename T, int VEC> struct Vec;
template <> struct Vec<__nv_bfloat16, 8> {
  using raw = uint4;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));   // read once: stream
  }
  static __device__ __forceinline__ raw zero() {
    return make_uint4(0, 0, 0, 0);
  }
  static __device__ __forceinline__ void widen(raw x, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};
template <> struct Vec<float, 4> {
  using raw = float4;
  static __device__ __forceinline__ raw load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void widen(raw x, float* f) {
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
};
template <typename T> struct Vec<T, 1> {
  using raw = float;
  static __device__ __forceinline__ raw load(const T* p) { return to_f32(*p); }
  static __device__ __forceinline__ raw zero() { return 0.f; }
  static __device__ __forceinline__ void widen(raw x, float* f) { f[0] = x; }
};

// The result of query row (bk, g): the normalised output in q's type, or
// in partial mode o = a / lsum (float32), and for e == 0 the row's m (base
// e; -2^30 for a block with no valid position) and l.
template <typename T>
__device__ __forceinline__ void put_row(T* out, float* po, float* pm,
                                        float* pl, size_t row, int hd, int e,
                                        float mx, float lsum, float a,
                                        int partial, int uniform) {
  const float o = a / fmaxf(lsum, 1e-30f);
  if (!partial) {
    out[row * hd + e] = from_f32<T>(o);
    return;
  }
  po[row * hd + e] = o;
  if (e == 0) {
    pm[row] = uniform ? kNegInf : mx * kLn2;
    pl[row] = lsum;
  }
}

// q (B, K, G, hd); k, v (B, S, K, hd); out (B, K, G, hd); all contiguous.
// Partial mode: out unused; po (B, K, G, hd), pm and pl (B, K, G) float32.
// Grid (splits, K, B), one cluster of `splits` blocks per (b, kh); block
// sp covers positions [lo + sp*split_len, min(hi + 1, lo + (sp + 1)*
// split_len)).  Lane (r, c) = (lane / LPR, lane % LPR) holds vectors
// c + LPR d (d < DV) of row r of each load step; nv = hd / VEC vectors
// make a row.  Shared memory: per warp and query row m, l and acc[hd],
// then the block's merged partial (m in base 2).
template <typename T, int VEC, int LPR, int DV, int GB>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ po, float* __restrict__ pm,
                    float* __restrict__ pl, int S, int K, int G, int hd,
                    int lo, int hi, int split_len, int splits, int uniform,
                    int partial, float qscale) {
  using V = Vec<T, VEC>;
  constexpr int RPW = 32 / LPR;              // rows a warp load covers
  constexpr int E = VEC * DV;                // elements a lane holds
  constexpr int U = 2;                       // load steps in flight a tile
  constexpr int STEP = kWarps * U * RPW;     // positions a block iteration
  extern __shared__ float smem[];
  const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int bk = b * K + kh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane / LPR, c = lane % LPR;
  const int nv = hd / VEC;
  const int start = lo + sp * split_len;
  const int end = min(hi + 1, start + split_len);
  const int rs = hd + 2;                     // m, l, acc[hd]
  const size_t kv_step = (size_t)K * hd;     // one position
  const T* kbase = k + ((size_t)b * S * K + kh) * hd;
  const T* vbase = v + ((size_t)b * S * K + kh) * hd;

  for (int g0 = 0; g0 < G; g0 += GB) {
    const int gn = min(GB, G - g0);
    const T* qbase = q + ((size_t)bk * G + g0) * hd;
    float qr[GB][E], acc[GB][E], m[GB], l[GB];
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      m[gi] = -INFINITY;
      l[gi] = 0.f;
#pragma unroll
      for (int d = 0; d < DV; ++d) {
        const int vi = c + LPR * d;
        float f[VEC];
        if (gi < gn && vi < nv) {
          V::widen(V::load(qbase + gi * hd + vi * VEC), f);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) f[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          qr[gi][d * VEC + j] = f[j] * qscale;
          acc[gi][d * VEC + j] = 0.f;
        }
      }
    }
    for (int t0 = start + warp * U * RPW; t0 < end; t0 += STEP) {
      typename V::raw kr[U][DV], vr[U][DV];   // every load of the tile first
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * RPW + r;
#pragma unroll
        for (int d = 0; d < DV; ++d) {
          const int vi = c + LPR * d;
          const bool ok = t < end && vi < nv;
          const size_t off = (size_t)t * kv_step + vi * VEC;
          kr[u][d] = ok ? V::load(kbase + off) : V::zero();
          vr[u][d] = ok ? V::load(vbase + off) : V::zero();
        }
      }
      float sc[U][GB];                        // scores, then weights
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[E];
#pragma unroll
        for (int d = 0; d < DV; ++d) V::widen(kr[u][d], kf + d * VEC);
        const bool live = t0 + u * RPW + r < end;
#pragma unroll
        for (int gi = 0; gi < GB; ++gi) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) s = fmaf(qr[gi][e], kf[e], s);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            s += __shfl_xor_sync(kFull, s, off);
          sc[u][gi] = live ? (uniform ? 0.f : s) : -INFINITY;
        }
      }
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {       // one max and rescale a tile
        float mt = sc[0][gi];
#pragma unroll
        for (int u = 1; u < U; ++u) mt = fmaxf(mt, sc[u][gi]);
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
        const float mn = fmaxf(m[gi], mt);   // finite: t0 itself is live
        const float alpha = exp2f(m[gi] - mn);
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sc[u][gi] = exp2f(sc[u][gi] - mn); // 0 for a dead row
          ps += sc[u][gi];
        }
        l[gi] = fmaf(l[gi], alpha, ps);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gi][e] *= alpha;
        m[gi] = mn;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[E];
#pragma unroll
        for (int d = 0; d < DV; ++d) V::widen(vr[u][d], vf + d * VEC);
#pragma unroll
        for (int gi = 0; gi < GB; ++gi)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[gi][e] = fmaf(sc[u][gi], vf[e], acc[gi][e]);
      }
    }
    // sum the warp's row groups (m is already the same in every lane)
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) {
        l[gi] += __shfl_xor_sync(kFull, l[gi], off);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[gi][e] += __shfl_xor_sync(kFull, acc[gi][e], off);
      }
    }
    float* mine = smem + (size_t)warp * GB * rs;
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      if (gi < gn) {
        if (lane == 0) {
          mine[gi * rs] = m[gi];
          mine[gi * rs + 1] = l[gi];
        }
        if (r == 0) {
#pragma unroll
          for (int d = 0; d < DV; ++d) {
            const int vi = c + LPR * d;
            if (vi < nv) {
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                mine[gi * rs + 2 + vi * VEC + j] = acc[gi][d * VEC + j];
            }
          }
        }
      }
    }
    __syncthreads();
    // merge the warps: rescale each to the common max and sum
    float* blk = smem + (size_t)kWarps * GB * rs;   // the block's partial
    for (int x = threadIdx.x; x < gn * hd; x += kThreads) {
      const int gi = x / hd;
      const int e = x - gi * hd;
      float mx = -INFINITY;
      for (int w = 0; w < kWarps; ++w)
        mx = fmaxf(mx, smem[((size_t)w * GB + gi) * rs]);
      float lsum = 0.f, a = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float* pw = smem + ((size_t)w * GB + gi) * rs;
        if (pw[0] == -INFINITY) continue;     // warp saw no position
        const float cw = exp2f(pw[0] - mx);
        lsum = fmaf(pw[1], cw, lsum);
        a = fmaf(pw[2 + e], cw, a);
      }
      if (splits == 1) {
        put_row(out, po, pm, pl, (size_t)bk * G + g0 + gi, hd, e, mx, lsum,
                a, partial, uniform);
      } else {
        if (e == 0) {
          blk[gi * rs] = mx;                  // finite: no split is empty
          blk[gi * rs + 1] = lsum;
        }
        blk[gi * rs + 2 + e] = a;
      }
    }
    if (splits > 1) {
      // the cluster's block 0 merges the splits from their shared memory
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();                         // every split's partial is in
      if (sp == 0) {
        for (int x = threadIdx.x; x < gn * hd; x += kThreads) {
          const int gi = x / hd;
          const int e = x - gi * hd;
          float mx = -INFINITY;
          for (int s = 0; s < splits; ++s)
            mx = fmaxf(mx, cluster.map_shared_rank(blk, s)[gi * rs]);
          float lsum = 0.f, a = 0.f;
          for (int s = 0; s < splits; ++s) {
            const float* ps = cluster.map_shared_rank(blk, s) + gi * rs;
            const float cs = exp2f(ps[0] - mx);
            lsum = fmaf(ps[1], cs, lsum);
            a = fmaf(ps[2 + e], cs, a);
          }
          put_row(out, po, pm, pl, (size_t)bk * G + g0 + gi, hd, e, mx,
                  lsum, a, partial, uniform);
        }
      }
      cluster.sync();                         // block 0 is done reading
    } else {
      __syncthreads();                        // smem reused by next group
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float *po, *pm, *pl;
  int B, S, K, G, hd, lo, hi, split_len, splits, uniform, partial;
  float qscale;
  cudaStream_t st;
};

template <typename T, int VEC, int LPR, int DV, int GB>
int launch(const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.K, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * (kWarps + 1) * GB * (a.hd + 2);
  cfg.stream = a.st;                          // <= 41 KB: no opt-in
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;        // the splits of one (b, kh)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_split_kernel<T, VEC, LPR, DV, GB>, (const T*)a.q,
      (const T*)a.k, (const T*)a.v, (T*)a.out, a.po, a.pm, a.pl, a.S, a.K,
      a.G, a.hd, a.lo, a.hi, a.split_len, a.splits, a.uniform, a.partial,
      a.qscale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int LPR, int DV>
int launch_g(const Args& a) {
  if (a.G == 1) return launch<T, VEC, LPR, DV, 1>(a);
  if (a.G <= 4) return launch<T, VEC, LPR, DV, 4>(a);
  return launch<T, VEC, LPR, DV, 8>(a);
}

// The lane layout for this head dimension: 16-byte vectors when rows and
// pointers allow, LPR the power of two (at least 4) of lanes that covers
// a row; else one element a lane, 32 lanes a row, up to 8 a lane.
template <typename T>
int launch_t(const Args& a, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  if (!vec_ok) return launch_g<T, 1, 32, 8>(a);
  const int nv = a.hd / VEC;
  if (nv <= 4) return launch_g<T, VEC, 4, 1>(a);
  if (nv <= 8) return launch_g<T, VEC, 8, 1>(a);
  if (nv <= 16) return launch_g<T, VEC, 16, 1>(a);
  if constexpr (sizeof(T) == 4) {             // float32, hd above 128
    if (nv > 32) return launch_g<T, VEC, 32, 2>(a);
  }
  return launch_g<T, VEC, 32, 1>(a);
}

}  // namespace

extern "C" int decode_attention_hdmax() { return HDMAX; }
extern "C" int decode_attention_max_splits() { return MAX_SPLITS; }

namespace {

int launch_checked(const Args& a, int dtype) {
  if (a.hd < 1 || a.hd > HDMAX || a.B < 0 || a.K < 1 || a.G < 1 || a.S < 1 ||
      a.lo < 0 || a.hi >= a.S || a.lo > a.hi || a.split_len < 1 ||
      a.splits < 1 || a.splits > MAX_SPLITS ||
      (long long)a.splits * a.split_len < a.hi - a.lo + 1 ||
      (long long)(a.splits - 1) * a.split_len >= a.hi - a.lo + 1 ||
      a.K > 65535 || a.B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const int esize = dtype == 0 ? 4 : 2;
  const uintptr_t ptrs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                         (a.partial ? (uintptr_t)a.po : (uintptr_t)a.out);
  const bool vec_ok = (a.hd * esize) % 16 == 0 && ptrs % 16 == 0;
  return dtype == 0 ? launch_t<float>(a, vec_ok)
                    : launch_t<__nv_bfloat16>(a, vec_ok);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  lo..hi are
// the valid cache positions, computed by the caller from pos and the
// window, cut into `splits` (at most MAX_SPLITS, the portable cluster
// size) ranges of `split_len`, none of them empty.  Launches on
// `stream` and returns the launch's error (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* out, int dtype,
                                       int B, int S, int K, int G, int hd,
                                       int lo, int hi, int uniform,
                                       int split_len, int splits, float scale,
                                       void* stream) {
  const Args a{q, k, v, out, nullptr, nullptr, nullptr, B, S, K, G, hd, lo,
               hi, split_len, splits, uniform, 0, scale * kLog2e,
               (cudaStream_t)stream};
  return launch_checked(a, dtype);
}

// Partial mode over one block of a cut cache: q, k, v as above (k, v the
// block, S its length); lo..hi the block's valid positions in its own
// numbering, or with `uniform` set (no valid position) 0..S-1; o (B, K,
// G, hd), m and l (B, K, G) float32, written in place of `out`.
extern "C" int decode_attention_partial_launch(
    const void* q, const void* k, const void* v, float* o, float* m,
    float* l, int dtype, int B, int S, int K, int G, int hd, int lo, int hi,
    int uniform, int split_len, int splits, float scale, void* stream) {
  const Args a{q, k, v, nullptr, o, m, l, B, S, K, G, hd, lo, hi, split_len,
               splits, uniform, 1, scale * kLog2e, (cudaStream_t)stream};
  return launch_checked(a, dtype);
}
