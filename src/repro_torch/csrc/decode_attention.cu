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
// heads x ~1,050 positions x 128 x 2 B x 2 = ~17 MB a layer, ~5 us at
// 3.35 TB/s) and does 4 G hd flops per position.  The design is the
// simplest correct one: one block of 8 warps per (batch, kv-head); warp w
// takes positions lo + w, lo + w + 8, ...; a lane holds elements
// lane + 32 j of the head dimension (j < D = ceil(hd / 32)) of the query
// rows, the key and value rows and the accumulators, so a row is one
// coalesced warp load and a score is one shuffle reduction.  Each warp
// keeps an online softmax (running max, normaliser, accumulator) in
// registers for up to GB query rows at once; the block merges the eight
// warps' partial states through shared memory at the end.  No S % block
// assumption: the loop runs over exactly the valid positions.  The TPU
// shaping (512-position VMEM blocks walked by a sequential grid axis) is
// gone: the position loop inside the block replaces it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define HDMAX 256   // head dimension: up to 8 elements a lane

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// q (B, K, G, hd); k, v (B, S, K, hd); out (B, K, G, hd); all contiguous.
// Valid positions are lo..hi (lo <= hi).  Shared memory: per warp and
// query row, the running max, the normaliser and hd accumulators.
template <int D, int GB, typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int S, int K,
              int G, int hd, int lo, int hi, int uniform, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_stride = hd + 2;              // m, l, acc[hd]
  const size_t kv_step = (size_t)K * hd;      // one position
  const T* kbase = k + ((size_t)b * S * K + kh) * hd;
  const T* vbase = v + ((size_t)b * S * K + kh) * hd;

  for (int g0 = 0; g0 < G; g0 += GB) {
    const int gn = min(GB, G - g0);
    const T* qbase = q + (((size_t)b * K + kh) * G + g0) * hd;
    float qr[GB][D], acc[GB][D], m[GB], l[GB];
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      m[gi] = -INFINITY;
      l[gi] = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const int e = lane + 32 * j;
        qr[gi][j] = (gi < gn && e < hd) ? to_f32(qbase[gi * hd + e]) : 0.f;
        acc[gi][j] = 0.f;
      }
    }
    for (int t = lo + warp; t <= hi; t += kWarps) {
      const T* kr = kbase + (size_t)t * kv_step;
      const T* vr = vbase + (size_t)t * kv_step;
      float kf[D], vf[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const int e = lane + 32 * j;
        kf[j] = e < hd ? to_f32(kr[e]) : 0.f;
        vf[j] = e < hd ? to_f32(vr[e]) : 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        if (gi < gn) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < D; ++j) s += qr[gi][j] * kf[j];
          s = warp_sum(s);
          s = uniform ? 0.f : s * scale;
          const float mn = fmaxf(m[gi], s);
          const float alpha = expf(m[gi] - mn);   // 0 on the first position
          const float p = expf(s - mn);
          l[gi] = l[gi] * alpha + p;
#pragma unroll
          for (int j = 0; j < D; ++j) acc[gi][j] = acc[gi][j] * alpha + p * vf[j];
          m[gi] = mn;
        }
      }
    }
    // each warp's partial state to shared memory
    float* mine = smem + (size_t)warp * GB * row_stride;
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      if (gi < gn) {
        if (lane == 0) {
          mine[gi * row_stride] = m[gi];
          mine[gi * row_stride + 1] = l[gi];
        }
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const int e = lane + 32 * j;
          if (e < hd) mine[gi * row_stride + 2 + e] = acc[gi][j];
        }
      }
    }
    __syncthreads();
    // merge the warps: rescale each to the common max, sum, normalise
    for (int x = threadIdx.x; x < gn * hd; x += kThreads) {
      const int gi = x / hd;
      const int e = x - gi * hd;
      float mx = -INFINITY;
      for (int w = 0; w < kWarps; ++w)
        mx = fmaxf(mx, smem[((size_t)w * GB + gi) * row_stride]);
      float lsum = 0.f, a = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float* part = smem + ((size_t)w * GB + gi) * row_stride;
        if (part[0] == -INFINITY) continue;    // warp saw no position
        const float c = expf(part[0] - mx);
        lsum += part[1] * c;
        a += part[2 + e] * c;
      }
      out[(((size_t)b * K + kh) * G + g0 + gi) * hd + e] =
          from_f32<T>(a / fmaxf(lsum, 1e-30f));
    }
    __syncthreads();                            // smem reused by next group
  }
}

template <int D, int GB, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int K, int G, int hd, int lo, int hi, int uniform,
           float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * kWarps * GB * (hd + 2);
  decode_kernel<D, GB, T><<<B * K, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, K, G, hd, lo, hi,
      uniform, scale);
  return (int)cudaGetLastError();
}

template <int GB, typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             int B, int S, int K, int G, int hd, int lo, int hi, int uniform,
             float scale, cudaStream_t st) {
  switch (D) {
#define CASE(d) \
  case d:       \
    return launch<d, GB, T>(q, k, v, out, B, S, K, G, hd, lo, hi, uniform, scale, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention_hdmax() { return HDMAX; }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  lo..hi are
// the valid cache positions, computed by the caller from pos and the
// window.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* out, int dtype,
                                       int B, int S, int K, int G, int hd,
                                       int lo, int hi, int uniform,
                                       float scale, void* stream) {
  if (hd < 1 || hd > HDMAX || B < 0 || K < 1 || G < 1 || S < 1 || lo < 0 ||
      hi >= S || lo > hi || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int D = (hd + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return G == 1 ? launch_d<1, float>(D, q, k, v, out, B, S, K, G, hd, lo,
                                       hi, uniform, scale, st)
                  : launch_d<4, float>(D, q, k, v, out, B, S, K, G, hd, lo,
                                       hi, uniform, scale, st);
  return G == 1 ? launch_d<1, __nv_bfloat16>(D, q, k, v, out, B, S, K, G, hd,
                                             lo, hi, uniform, scale, st)
                : launch_d<4, __nv_bfloat16>(D, q, k, v, out, B, S, K, G, hd,
                                             lo, hi, uniform, scale, st);
}
