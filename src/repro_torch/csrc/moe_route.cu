// MoE router (softmax over the experts, then top-k) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_route/kernel.py
// `route_pallas` (body `_route_kernel`).  It computes what
// repro_torch.kernels.moe_route.ref.route_ref computes: per token a
// softmax over its E logits in float32, then k rounds of (max, argmax in
// which the lowest expert index wins a tie, mask the winner), then,
// optionally, the k weights divided by their sum.
//
// What bounds it on the H100: bytes.  A token reads E logits and writes
// 2k numbers (OLMoE: 64 float32 in, 8 float32 + 8 int32 out), and its
// work is E exponentials and k warp reductions, far below the card's
// rates; at the serving shapes (4 tokens a decode step, 1,024 a prefill)
// a launch costs more than the work.  The design is the simplest that
// keeps everything in registers: one warp per token, expert e held by
// lane e % 32 in slot e / 32 (two slots a lane for E = 64), a warp
// shuffle reduction for the max and the sum, and for each of the k
// rounds a shuffle argmax over (value desc, index asc).  There is no
// padding of E or of the token count: lanes past E hold a value below
// every probability, and warps past the last token return at once.
// The TPU shaping (E padded to 128 lanes, 256-token blocks) is gone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define EMAX 512   // experts a token may have: 16 register slots a lane
#define KMAX 64    // experts a token may choose

namespace {

constexpr int kWarps = 8;               // tokens per block
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = EMAX / 32;
constexpr int kOut = KMAX / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
route_kernel(const T* __restrict__ logits, float* __restrict__ w_out,
             int* __restrict__ i_out, int n_tok, int E, int k,
             int renormalize) {
  const int lane = threadIdx.x & 31;
  const int tok = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tok >= n_tok) return;              // the whole warp leaves together
  const T* row = logits + (size_t)tok * E;

  // softmax over the E logits, float32
  float p[kSlots];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? load_f32(row + e) : -INFINITY;
    m = fmaxf(m, p[j]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (lane + 32 * j < E) {
      p[j] = expf(p[j] - m);
      s += p[j];
    }
  }
  s = warp_sum(s);
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    p[j] = lane + 32 * j < E ? p[j] / s : -1.f;   // -1: never chosen

  // k rounds: warp argmax, the lowest index wins a tie, then mask it
  float my_w[kOut];
  int my_i[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    my_w[i] = 0.f;
    my_i[i] = 0;
  }
  for (int r = 0; r < k; ++r) {
    float bv = -2.f;
    int bi = EMAX;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {   // slots ascend in index: strict >
      if (p[j] > bv) {
        bv = p[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (lane + 32 * j == bi) p[j] = -1.f;
#pragma unroll
    for (int i = 0; i < kOut; ++i)
      if (lane + 32 * i == r) {
        my_w[i] = bv;
        my_i[i] = bi;
      }
  }
  if (renormalize) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kOut; ++i)
      if (lane + 32 * i < k) part += my_w[i];
    const float tot = warp_sum(part);
#pragma unroll
    for (int i = 0; i < kOut; ++i) my_w[i] = my_w[i] / tot;
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int r = lane + 32 * i;
    if (r < k) {
      w_out[(size_t)tok * k + r] = my_w[i];
      i_out[(size_t)tok * k + r] = my_i[i];
    }
  }
}

}  // namespace

extern "C" int moe_route_emax() { return EMAX; }
extern "C" int moe_route_kmax() { return KMAX; }

// dtype: 0 = float32 logits, 1 = bfloat16 logits.  Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int moe_route_launch(const void* logits, int dtype, void* w_out,
                                void* i_out, int n_tok, int E, int k,
                                int renormalize, void* stream) {
  if (E < 1 || E > EMAX || k < 1 || k > KMAX || k > E || n_tok < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n_tok == 0) return 0;
  const dim3 grid((n_tok + kWarps - 1) / kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    route_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)logits, (float*)w_out, (int*)i_out, n_tok, E, k,
        renormalize);
  else
    route_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)logits, (float*)w_out, (int*)i_out, n_tok, E,
        k, renormalize);
  return (int)cudaGetLastError();
}
