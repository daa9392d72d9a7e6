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
// keys and values of its valid positions once and does 4 G hd flops per
// position, far below the bf16 rate (gemma3's local layer: 33.6 MB, 10 us
// at 3.35 TB/s; its global cache at position 20,000: 655 MB, 196 us).  The
// card reaches its memory rate only with tens of KB in flight on every SM
// the whole time, and the serving shapes are so short (10-20 us) that a
// fixed cost of a few us (launch, the first load's latency, the merge)
// weighs as much as the bytes.  So the design keeps the loads going and the
// tail short:
//
//   1. Split-KV with no cap from a cluster.  The valid positions lo..hi
//      are cut into `splits` contiguous ranges of `split_len` (none
//      empty); the wrapper picks the count so that the grid (splits,
//      K x G-chunks, B) fills the blocks that fit on the SMs at once,
//      whatever B K is (paligemma's 2 groups get 8 splits, one group of
//      4,096 positions 128).  Each split writes its float32 (m, l) and
//      acc[hd] to a scratch that the wrapper keeps; the last split of a
//      group to arrive (an arrival counter: one acq_rel atomic add a
//      block, after a barrier) merges all of them by log-sum-exp in split
//      order, so two calls give the same bits, and sets the counter back
//      to 0: no memset launch.  (The wrapper zeroes counters only when it
//      makes them: one set a stream for eager launches, one set a graph
//      capture, so graphs replay in any order.)  The merge
//      issues the loads of 8 splits (their m, l and acc, for up to 2
//      vectors of 4 elements a thread) before it uses any: one L2 round
//      trip per 8 splits, not one per element.  A plan of one split writes
//      its output directly.
//   2. K/V through a shared-memory ring.  Each warp walks its own tiles
//      of 16 positions (tiles w, w + warps, ... of its block's split)
//      through a private ring of kStages (3) slots (2 blocks of kWarps (4)
//      warps an SM at hd 128; fewer warps where rows are so long that the
//      rings would not fit), filled by 16-byte cp.async (4-byte, or plain
//      loads, where rows or pointers are not aligned).  A tile is copied
//      flat: the (row, 16-byte chunk) pairs of its keys and values are
//      dealt out over the 32 lanes, so rows of 160 bytes (hd 80 in bf16)
//      leave no lane idle.  While a warp computes one tile, the next
//      kStages - 1 are in flight.  Rows sit in shared memory at an odd
//      multiple of 16 bytes, so ldmatrix and row reads are free of bank
//      conflicts.  (Measured on an H100 and dropped, see PERF.md: bulk
//      copies by TMA with mbarriers, 2-3 us slower on the serving shapes;
//      2 or 4 stages, or 2 warps, no better overall; merging plans of <= 8
//      splits in a thread-block cluster, 1.4-1.9x slower: clusters of
//      blocks this large schedule badly.)
//   3. Exact query-group widths: G 1, 2, 4 and 8 are instantiated; a G
//      above 8 takes a grid row per group of 8 query rows (each re-reads
//      the cache).
//   4. Scores on the tensor cores for bf16 (hd a multiple of 16):
//      mma.sync.m16n8k16 with the tile's 16 positions as M (ldmatrix from
//      the ring) and the <= 8 query rows as N, float32 accumulation of
//      exact bf16 products: only the summation order differs from the
//      plain version, and no shuffle tree remains.  float32 inputs (and
//      bf16 rows that are not 16-element multiples) take the scores on
//      CUDA cores from the ring, two lanes a position.  The scores are
//      scaled by hd^-0.5 log2 e in float32 and the softmax runs in base 2:
//      one max and one rescale a tile, each weight one exp2f.  The
//      probabilities stay float32 up to the value product, which runs on
//      CUDA cores (a lane holds 1-8 consecutive elements of the row).
//
// Partial mode (decode_attention_partial_launch): the same kernel over one
// block of a cache whose sequence is cut over several ranks.  Where the
// merge would write the normalised output in q's type, it writes three
// float32 results instead, for the caller's cross-rank merge: o = acc / l,
// m the row max of the scaled scores (in base e) and l the sum of
// exp(score - m).  A block that holds no valid position runs the uniform
// case (every score 0 over all S positions), which gives l = S and o the
// mean of the values, and reports m = -2^30, the reference's mask value:
// every one of its scores is masked, so it weighs nothing beside a block
// that holds a valid position.  Rounding to q's type happens once, after
// the merge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define HDMAX 256       // head dimension: up to 8 elements a lane
#define MAX_SPLITS 128  // splits of one group

namespace {

constexpr int kTile = 16;                  // positions a ring slot holds
constexpr int kWarps = 4;                  // warps a block, at most
constexpr int kStages = 3;                 // ring slots a warp
constexpr int kSmemMax = 232448 - 64;      // dynamic, beside s_last
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// E consecutive elements of a shared-memory row, widened to float32: one
// load of 2-16 bytes (the lane's offset is a multiple of its width).
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* p, float* f) {
  constexpr int BYTES = (int)sizeof(T) * E;
  if constexpr (BYTES == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const T* h = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] = to_f32(h[j]);
  } else if constexpr (BYTES == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const T* h = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] = to_f32(h[j]);
  } else if constexpr (BYTES == 4) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    const T* h = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] = to_f32(h[j]);
  } else if constexpr (BYTES == 32) {        // float32, 8 a lane
    const uint4 x = reinterpret_cast<const uint4*>(p)[0];
    const uint4 y = reinterpret_cast<const uint4*>(p)[1];
    const T* h = reinterpret_cast<const T*>(&x);
    const T* g = reinterpret_cast<const T*>(&y);
#pragma unroll
    for (int j = 0; j < E / 2; ++j) {
      f[j] = to_f32(h[j]);
      f[E / 2 + j] = to_f32(g[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] = to_f32(p[j]);
  }
}

// q (B, K, G, hd); k, v (B, S, K, hd); out (B, K, G, hd); all contiguous.
// Partial mode: out unused; po (B, K, G, hd), pm and pl (B, K, G) float32.
// ws: float32 scratch of the splits' (m in base 2, l) as (groups, splits,
// GB, 2), then (from a multiple of 4 floats) their acc as (groups, splits,
// GB, hd); cnt: one int32
// arrival counter a group, 0 between launches.  A group is (b, kh, gc): gc
// the chunk of 8 query rows.
struct Params {
  const void *q, *k, *v;
  void* out;
  float *po, *pm, *pl, *ws;
  int* cnt;
  int S, K, G, hd, lo, hi, split_len, splits, uniform, partial;
  int ngc;         // query-row chunks a kv head (G > 8: ceil(G / 8))
  int stride;      // bytes between rows in the ring (an odd multiple of 16)
  int chunk;       // copy width: 16 or 4 (cp.async) or 2 (plain loads)
  int ring_bytes;  // all warps' rings, the start of the per-warp scores
  float qscale;    // hd^-0.5 log2 e
};

// The result of query row `row` (element e): the normalised output in q's
// type, or in partial mode o = a / lsum (float32), and for e == 0 the row's
// m (base e; -2^30 for a block with no valid position) and l.
template <typename T>
__device__ __forceinline__ void put_row(const Params& p, size_t row, int e,
                                        float mx, float lsum, float a) {
  const float o = a / fmaxf(lsum, 1e-30f);
  if (!p.partial) {
    reinterpret_cast<T*>(p.out)[row * p.hd + e] = from_f32<T>(o);
    return;
  }
  p.po[row * p.hd + e] = o;
  if (e == 0) {
    p.pm[row] = p.uniform ? kNegInf : mx * kLn2;
    p.pl[row] = lsum;
  }
}

// Copy the 16 positions t0.. of this (b, kh) into ring slot `slot`: keys,
// then values, each row at `stride` bytes.  Rows at or past `end` are
// zero-filled, so a dead row's weight (0) meets a value of 0.
template <typename T>
__device__ __forceinline__ void issue_tile(const Params& p, const T* kb,
                                           const T* vb, unsigned char* slot,
                                           int t0, int end, int lane) {
  const int rowbytes = p.hd * (int)sizeof(T);
  const size_t step = (size_t)p.K * p.hd;
  unsigned char* sk = slot;
  unsigned char* sv = slot + kTile * p.stride;
  if (p.chunk == 2) {                         // unaligned rows: plain loads
    for (int i = lane; i < kTile * p.hd; i += 32) {
      const int r = i / p.hd, e = i - r * p.hd;
      const int t = t0 + r;
      T kx = from_f32<T>(0.f), vx = kx;
      if (t < end) {
        kx = kb[(size_t)t * step + e];
        vx = vb[(size_t)t * step + e];
      }
      reinterpret_cast<T*>(sk + r * p.stride)[e] = kx;
      reinterpret_cast<T*>(sv + r * p.stride)[e] = vx;
    }
    return;
  }
  const int nch = rowbytes / p.chunk;         // chunks a row
  const int dr = 32 / nch, dc = 32 % nch;     // a lane's step over (r, c)
  int r = lane / nch, c = lane % nch;
  const uint32_t dk = smem_u32(sk), dv = smem_u32(sv);
  while (r < kTile) {
    const int t = t0 + r;
    const int live = t < end;
    const size_t off = (size_t)(live ? t : 0) * step * sizeof(T) +
                       (size_t)c * p.chunk;
    const char* ks = reinterpret_cast<const char*>(kb) + off;
    const char* vs = reinterpret_cast<const char*>(vb) + off;
    const uint32_t so = r * p.stride + c * p.chunk;
    if (p.chunk == 16) {
      cp_async16(dk + so, ks, live ? 16 : 0);
      cp_async16(dv + so, vs, live ? 16 : 0);
    } else {
      cp_async4(dk + so, ks, live ? 4 : 0);
      cp_async4(dv + so, vs, live ? 4 : 0);
    }
    r += dr;
    c += dc;
    if (c >= nch) {
      c -= nch;
      ++r;
    }
  }
}

// Grid (splits, K * ngc, B); block sp covers positions [lo + sp*split_len,
// min(hi + 1, lo + (sp + 1)*split_len)).  Warp w takes the block's tiles w,
// w + warps, ...; lane j of the value product holds elements j EPL ..
// j EPL + EPL - 1 of a row.  MMA: the scores by mma.sync (bf16, hd a
// multiple of 16), else on CUDA cores.
template <typename T, bool MMA, int GB, int EPL>
__global__ void __launch_bounds__(32 * kWarps)
decode_split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sp = blockIdx.x;
  const int gc = blockIdx.y % p.ngc, kh = blockIdx.y / p.ngc;
  const int b = blockIdx.z;
  const int bk = b * p.K + kh;
  const int grp = bk * p.ngc + gc;
  const int g0 = gc * 8;
  const int gn = min(GB, p.G - g0);
  const int hd = p.hd;
  const int start = p.lo + sp * p.split_len;
  const int end = min(p.hi + 1, start + p.split_len);
  const int slot_bytes = 2 * kTile * p.stride;
  unsigned char* ring = smem + (size_t)warp * kStages * slot_bytes;
  float* sp_base = reinterpret_cast<float*>(smem + p.ring_bytes);
  float* sP = sp_base + warp * (kTile * 8 + 8);   // scores, then weights
  float* sA = sP + kTile * 8;                     // a tile's rescale
  float* sQ = sp_base + nw * (kTile * 8 + 8);     // q as float32 (no MMA)
  const T* kb = reinterpret_cast<const T*>(p.k) +
                ((size_t)b * p.S * p.K + kh) * hd;
  const T* vb = reinterpret_cast<const T*>(p.v) +
                ((size_t)b * p.S * p.K + kh) * hd;
  const T* qb = reinterpret_cast<const T*>(p.q) + ((size_t)bk * p.G + g0) * hd;

  // this warp's tiles: w, w + nw, ... of the split's tiles
  const int ntile = (end - start + kTile - 1) / kTile;
  const int my = ntile > warp ? (ntile - warp + nw - 1) / nw : 0;
  for (int i = 0; i < kStages - 1; ++i) {     // the ring's first tiles
    if (i < my)
      issue_tile<T>(p, kb, vb, ring + i * slot_bytes,
                    start + (warp + i * nw) * kTile, end, lane);
    cp_commit();
  }

  // q: B fragments of the mma (query row lane / 4), or float32 in smem
  uint32_t qf[MMA ? 2 * EPL : 1][2];
  if constexpr (MMA) {
    const int n = lane >> 2, kq = (lane & 3) * 2;
#pragma unroll
    for (int kk = 0; kk < 2 * EPL; ++kk) {
      const int e = kk * 16 + kq;
      if (n < gn && e < hd) {
        const T* qr = qb + (size_t)n * hd + e;
        qf[kk][0] = pack_bf16(qr[0], qr[1]);
        qf[kk][1] = pack_bf16(qr[8], qr[9]);
      } else {
        qf[kk][0] = qf[kk][1] = 0u;
      }
    }
  } else {
    for (int x = threadIdx.x; x < GB * hd; x += blockDim.x) {
      const int g = x / hd;
      sQ[x] = g < gn ? to_f32(qb[x]) : 0.f;
    }
    __syncthreads();
  }

  // softmax state of column c = lane / 4 (query row), rows (lane & 3) + 4j
  const int c = lane >> 2;
  float m_c = -INFINITY, l_c = 0.f;
  float acc[GB][EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[g][j] = 0.f;
  const int e0 = lane * EPL;

  for (int i = 0; i < my; ++i) {
    const int nxt = i + kStages - 1;
    if (nxt < my)
      issue_tile<T>(p, kb, vb, ring + (nxt % kStages) * slot_bytes,
                    start + (warp + nxt * nw) * kTile, end, lane);
    cp_commit();
    cp_wait<kStages - 1>();                   // tile i has landed
    __syncwarp();
    const unsigned char* sk = ring + (i % kStages) * slot_bytes;
    const unsigned char* sv = sk + kTile * p.stride;
    const int t0 = start + (warp + i * nw) * kTile;

    // the tile's 16 x 8 scores (scaled, base 2; dead rows -inf) -> sP
    if constexpr (MMA) {
      float cc[4] = {0.f, 0.f, 0.f, 0.f};
      const uint32_t a0 = smem_u32(sk) + (lane & 15) * p.stride +
                          (lane >> 4) * 16;
#pragma unroll
      for (int kk = 0; kk < 2 * EPL; ++kk) {
        if (kk * 16 < hd) {
          uint32_t a[4];
          ldmatrix_x4(a0 + kk * 32, a);
          mma_bf16(cc, a, qf[kk]);
        }
      }
      const int r0 = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool live = t0 + r0 + 8 * h < end;
        float2 s;
        s.x = live ? (p.uniform ? 0.f : cc[2 * h] * p.qscale) : -INFINITY;
        s.y = live ? (p.uniform ? 0.f : cc[2 * h + 1] * p.qscale)
                   : -INFINITY;
        *reinterpret_cast<float2*>(sP + (r0 + 8 * h) * 8 + cq) = s;
      }
    } else {
      const int r = lane & 15, half = lane >> 4;
      const int hh = (hd + 1) >> 1;
      const int ea = half ? hh : 0, eb = half ? hd : hh;
      const T* krow = reinterpret_cast<const T*>(sk + r * p.stride);
      float s[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) s[g] = 0.f;
      for (int e = ea; e < eb; ++e) {
        const float kv = to_f32(krow[e]);
#pragma unroll
        for (int g = 0; g < GB; ++g) s[g] = fmaf(sQ[g * hd + e], kv, s[g]);
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) s[g] += __shfl_xor_sync(kFull, s[g], 16);
      const bool live = t0 + r < end;
      if (half == 0) {
#pragma unroll
        for (int g = 0; g < GB; ++g)
          sP[r * 8 + g] = live ? (p.uniform ? 0.f : s[g] * p.qscale)
                               : -INFINITY;
#pragma unroll
        for (int g = GB; g < 8; ++g) sP[r * 8 + g] = 0.f;
      }
    }
    __syncwarp();

    // one max and one rescale a tile for each query row
    {
      float sv4[4];
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sv4[j] = sP[((lane & 3) + 4 * j) * 8 + c];
        tm = fmaxf(tm, sv4[j]);
      }
      tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, 1));
      tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, 2));
      const float mn = fmaxf(m_c, tm);        // finite: the tile has a row
      const float alpha = exp2f(m_c - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = exp2f(sv4[j] - mn);  // 0 for a dead row
        sP[((lane & 3) + 4 * j) * 8 + c] = pj;
        ps += pj;
      }
      l_c = fmaf(l_c, alpha, ps);
      m_c = mn;
      if ((lane & 3) == 0) sA[c] = alpha;
    }
    __syncwarp();

    // acc = alpha acc + sum_t p_t v_t over the tile's rows
    if (e0 < hd) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float al = sA[g];
#pragma unroll
        for (int j = 0; j < EPL; ++j) acc[g][j] *= al;
      }
      const T* vrow = reinterpret_cast<const T*>(sv) + e0;
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float vf[EPL];
        load_row<T, EPL>(reinterpret_cast<const T*>(
                             reinterpret_cast<const unsigned char*>(vrow) +
                             r * p.stride), vf);
        float pr[GB];
        if constexpr (GB >= 4) {
#pragma unroll
          for (int g4 = 0; g4 < GB; g4 += 4) {
            const float4 x = *reinterpret_cast<const float4*>(sP + r * 8 +
                                                              g4);
            pr[g4] = x.x; pr[g4 + 1] = x.y; pr[g4 + 2] = x.z;
            pr[g4 + 3] = x.w;
          }
        } else if constexpr (GB == 2) {
          const float2 x = *reinterpret_cast<const float2*>(sP + r * 8);
          pr[0] = x.x; pr[1] = x.y;
        } else {
          pr[0] = sP[r * 8];
        }
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int j = 0; j < EPL; ++j)
            acc[g][j] = fmaf(pr[g], vf[j], acc[g][j]);
      }
    }
    __syncwarp();                             // before sP and the slot refill
  }
  cp_wait<0>();
  __syncthreads();                            // every ring is free now

  // each warp's (m, l, acc) into smem (over the rings), then the block's
  const int rs = hd + 2;
  float* W = reinterpret_cast<float*>(smem);
  l_c += __shfl_xor_sync(kFull, l_c, 1);
  l_c += __shfl_xor_sync(kFull, l_c, 2);
  if ((lane & 3) == 0 && c < gn) {
    W[(warp * GB + c) * rs] = m_c;            // -inf: the warp saw nothing
    W[(warp * GB + c) * rs + 1] = l_c;
  }
  if (e0 < hd) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        if (g < gn && e0 + j < hd) W[(warp * GB + g) * rs + 2 + e0 + j] =
            acc[g][j];
  }
  __syncthreads();
  const size_t row0 = (size_t)bk * p.G + g0;
  // the scratch's acc region starts after every split's (m, l), 16-byte
  // aligned
  const size_t acc_off =
      ((size_t)p.ngc * p.K * gridDim.z * p.splits * GB * 2 + 3) & ~(size_t)3;
  for (int x = threadIdx.x; x < gn * hd; x += blockDim.x) {
    const int g = x / hd;
    const int e = x - g * hd;
    float mx = -INFINITY;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, W[(w * GB + g) * rs]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* pw = W + (w * GB + g) * rs;
      if (pw[0] == -INFINITY) continue;       // warp saw no position
      const float cw = exp2f(pw[0] - mx);
      lsum = fmaf(pw[1], cw, lsum);
      a = fmaf(pw[2 + e], cw, a);
    }
    if (p.splits == 1) {
      put_row<T>(p, row0 + g, e, mx, lsum, a);
    } else {                                  // mx finite: no split empty
      const size_t r = ((size_t)grp * p.splits + sp) * GB + g;
      if (e == 0) {
        p.ws[2 * r] = mx;
        p.ws[2 * r + 1] = lsum;
      }
      p.ws[acc_off + r * hd + e] = a;
    }
  }
  if (p.splits == 1) return;

  // the last split of the group to arrive merges them all, in split order.
  // One thread's acq_rel add publishes the block's writes (ordered before
  // it by the barrier) and, in the last block, acquires the others'.
  __syncthreads();
  if (threadIdx.x == 0) {
    int arrived;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(arrived)
                 : "l"(p.cnt + grp)
                 : "memory");
    s_last = arrived == p.splits - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // each element's log-sum-exp over the splits in split order, 8 splits a
  // batch: a thread takes up to 2 vectors of 4 elements (1 where hd is not
  // a multiple of 4) and issues every load of a batch (each split's m, l
  // and acc) before it uses any, so 8 splits cost one L2 round trip; the
  // running max and sums are rescaled once a batch
  const int ns = p.splits;
  const float2* wm = reinterpret_cast<const float2*>(p.ws) +
                     (size_t)grp * ns * GB;            // (splits, GB) m, l
  const float* wa = p.ws + acc_off + (size_t)grp * ns * GB * hd;
  const int vw = hd % 4 == 0 ? 4 : 1;                // elements a vector
  const int nv = gn * hd / vw;
  for (int x0 = threadIdx.x; x0 < nv; x0 += 2 * blockDim.x) {
    float M[2] = {-INFINITY, -INFINITY}, L[2] = {0.f, 0.f};
    float a[2][4] = {};
    for (int s0 = 0; s0 < ns; s0 += 8) {
      float4 v[2][8];
      float2 ml[2][8];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int x = x0 + u * blockDim.x;
        const int g = x * vw / hd;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[u][j] = make_float4(0.f, 0.f, 0.f, 0.f);
          ml[u][j] = make_float2(-INFINITY, 0.f);
          if (x < nv && s0 + j < ns) {
            const size_t r = (size_t)(s0 + j) * GB + g;
            ml[u][j] = __ldcg(wm + r);
            const float* src = wa + r * hd + (size_t)(x * vw - g * hd);
            if (vw == 4)
              v[u][j] = __ldcg(reinterpret_cast<const float4*>(src));
            else
              v[u][j].x = __ldcg(src);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float Mn = M[u];
#pragma unroll
        for (int j = 0; j < 8; ++j) Mn = fmaxf(Mn, ml[u][j].x);
        const float r = Mn == -INFINITY ? 0.f : exp2f(M[u] - Mn);
        L[u] *= r;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) a[u][c4] *= r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float w = ml[u][j].x == -INFINITY
                              ? 0.f : exp2f(ml[u][j].x - Mn);  // 0: no split
          L[u] = fmaf(ml[u][j].y, w, L[u]);
          a[u][0] = fmaf(v[u][j].x, w, a[u][0]);
          a[u][1] = fmaf(v[u][j].y, w, a[u][1]);
          a[u][2] = fmaf(v[u][j].z, w, a[u][2]);
          a[u][3] = fmaf(v[u][j].w, w, a[u][3]);
        }
        M[u] = Mn;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int x = x0 + u * blockDim.x;
      if (x >= nv) continue;
      const int g = x * vw / hd;
      const int e = x * vw - g * hd;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < vw) put_row<T>(p, row0 + g, e + j, M[u], L[u], a[u][j]);
    }
  }
  if (threadIdx.x == 0) p.cnt[grp] = 0;       // ready for the next launch
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float *po, *pm, *pl, *ws;
  int* cnt;
  int B, S, K, G, hd, lo, hi, split_len, splits, uniform, partial;
  float qscale;
  cudaStream_t st;
};

int gb_of(int G) { return G == 1 ? 1 : G == 2 ? 2 : G <= 4 ? 4 : 8; }
int stride_of(int hd, int esize) {           // an odd number of 16 bytes
  return (((hd * esize + 15) / 16) | 1) * 16;
}

// Dynamic shared memory of a block: the warps' rings (or, after them, the
// warps' partials), the per-warp scores, and q in float32.  The block has
// kWarps warps, fewer where they would not fit (float32 rows over ~140).
int smem_of(int esize, int hd, int G, int* warps, int* ring_bytes) {
  const int GB = gb_of(G), stride = stride_of(hd, esize);
  for (*warps = kWarps;; --*warps) {
    const int ring = *warps * kStages * 2 * kTile * stride;
    const int merge = 4 * *warps * GB * (hd + 2);
    const int head = ((ring > merge ? ring : merge) + 15) & ~15;
    const int total = head + 4 * (*warps * (kTile * 8 + 8) + GB * hd);
    if (total <= kSmemMax || *warps == 1) {
      *ring_bytes = head;
      return total;
    }
  }
}

template <typename T, bool MMA, int GB, int EPL>
int launch(const Args& a, int chunk) {
  auto kern = decode_split_kernel<T, MMA, GB, EPL>;
  static bool opted[64] = {};                 // per device: the opt-in
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  int warps = 0, ring_bytes = 0;
  const int smem = smem_of((int)sizeof(T), a.hd, a.G, &warps, &ring_bytes);
  Params p;
  p.q = a.q; p.k = a.k; p.v = a.v; p.out = a.out;
  p.po = a.po; p.pm = a.pm; p.pl = a.pl; p.ws = a.ws; p.cnt = a.cnt;
  p.S = a.S; p.K = a.K; p.G = a.G; p.hd = a.hd; p.lo = a.lo; p.hi = a.hi;
  p.split_len = a.split_len; p.splits = a.splits; p.uniform = a.uniform;
  p.partial = a.partial;
  p.ngc = (a.G + 7) / 8;
  p.stride = stride_of(a.hd, (int)sizeof(T));
  p.chunk = chunk;
  p.ring_bytes = ring_bytes;
  p.qscale = a.qscale;
  const dim3 grid(a.splits, a.K * p.ngc, a.B);
  kern<<<grid, 32 * warps, smem, a.st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool MMA, int GB>
int launch_e(const Args& a, int chunk) {
  if (a.hd <= 32) return launch<T, MMA, GB, 1>(a, chunk);
  if (a.hd <= 64) return launch<T, MMA, GB, 2>(a, chunk);
  if (a.hd <= 128) return launch<T, MMA, GB, 4>(a, chunk);
  return launch<T, MMA, GB, 8>(a, chunk);
}

template <typename T, bool MMA>
int launch_g(const Args& a, int chunk) {
  switch (gb_of(a.G)) {
    case 1: return launch_e<T, MMA, 1>(a, chunk);
    case 2: return launch_e<T, MMA, 2>(a, chunk);
    case 4: return launch_e<T, MMA, 4>(a, chunk);
    default: return launch_e<T, MMA, 8>(a, chunk);
  }
}

int launch_checked(const Args& a, int dtype) {
  const long long n = (long long)a.hi - a.lo + 1;
  if (a.hd < 1 || a.hd > HDMAX || a.B < 0 || a.K < 1 || a.G < 1 || a.S < 1 ||
      a.lo < 0 || a.hi >= a.S || a.lo > a.hi || a.split_len < 1 ||
      a.splits < 1 || a.splits > MAX_SPLITS ||
      (long long)a.splits * a.split_len < n ||
      (long long)(a.splits - 1) * a.split_len >= n ||
      (a.splits > 1 && (a.ws == nullptr || a.cnt == nullptr)) ||
      (long long)a.K * ((a.G + 7) / 8) > 65535 || a.B > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const int esize = dtype == 0 ? 4 : 2;
  const int rowbytes = a.hd * esize;
  const uintptr_t kv = (uintptr_t)a.k | (uintptr_t)a.v;
  const int chunk = rowbytes % 16 == 0 && kv % 16 == 0 ? 16
                    : rowbytes % 4 == 0 && kv % 4 == 0 ? 4
                                                       : 2;
  if (dtype == 0) return launch_g<float, false>(a, chunk);
  if (a.hd % 16 == 0) return launch_g<__nv_bfloat16, true>(a, chunk);
  return launch_g<__nv_bfloat16, false>(a, chunk);
}

}  // namespace

extern "C" int decode_attention_hdmax() { return HDMAX; }
extern "C" int decode_attention_max_splits() { return MAX_SPLITS; }

// A block's dynamic shared memory in bytes for this dtype (0 = float32, 1
// = bfloat16), head dimension and G, as the launch gives it: the wrapper's
// split plan counts the blocks that fit on an SM from it.
extern "C" int decode_attention_smem(int dtype, int hd, int G) {
  int warps = 0, ring_bytes = 0;
  return smem_of(dtype == 0 ? 4 : 2, hd, G, &warps, &ring_bytes);
}

// The id of the CUDA graph capture under way on `stream` into *id (0 when
// none is); returns the query's error (0 = none).  The wrapper gives each
// capture arrival counters of its own.
extern "C" int decode_attention_capture_id(void* stream,
                                           unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long got = 0;
  const cudaError_t e =
      cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &got);
  *id = status == cudaStreamCaptureStatusActive ? got : 0;
  return (int)e;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  lo..hi are
// the valid cache positions, computed by the caller from pos and the
// window, cut into `splits` (at most MAX_SPLITS) ranges of `split_len`,
// none of them empty.  With more than one split, ws is a float32 scratch
// of 2 R rounded up to a multiple of 4, plus R hd floats (R = B K
// ceil(G / 8) splits GB, GB: G rounded up to 1, 2, 4 or 8, at most 8) and
// cnt B K ceil(G / 8) int32 counters that are 0 (the kernel leaves them
// 0).  Launches on `stream` and returns the launch's error (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* out, float* ws,
                                       int* cnt, int dtype, int B, int S,
                                       int K, int G, int hd, int lo, int hi,
                                       int uniform, int split_len, int splits,
                                       float scale, void* stream) {
  const Args a{q, k, v, out, nullptr, nullptr, nullptr, ws, cnt, B, S, K, G,
               hd, lo, hi, split_len, splits, uniform, 0, scale * kLog2e,
               (cudaStream_t)stream};
  return launch_checked(a, dtype);
}

// Partial mode over one block of a cut cache: q, k, v as above (k, v the
// block, S its length); lo..hi the block's valid positions in its own
// numbering, or with `uniform` set (no valid position) 0..S-1; o (B, K,
// G, hd), m and l (B, K, G) float32, written in place of `out`.
extern "C" int decode_attention_partial_launch(
    const void* q, const void* k, const void* v, float* o, float* m,
    float* l, float* ws, int* cnt, int dtype, int B, int S, int K, int G,
    int hd, int lo, int hi, int uniform, int split_len, int splits,
    float scale, void* stream) {
  const Args a{q, k, v, nullptr, o, m, l, ws, cnt, B, S, K, G, hd, lo, hi,
               split_len, splits, uniform, 1, scale * kLog2e,
               (cudaStream_t)stream};
  return launch_checked(a, dtype);
}
