// MoE router (softmax over the experts, top-k, and the dense combine
// weights) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_route/kernel.py
// `route_pallas` (body `_route_kernel`).  It computes what
// repro_torch.kernels.moe_route.ref.route_ref computes: per token a
// softmax over its E logits in float32, then k rounds of (max, argmax in
// which the lowest expert index wins a tie, mask the winner), then,
// optionally, the k weights divided by their sum.  When it is given a
// `dense` row buffer it also writes what ref.route_dense_ref builds from
// those outputs with zeros -> scatter_ -> .to(dtype) (the reference's
// `dense_w.at[...].set(w).astype(x.dtype)` in models/layers.py
// moe_dense): the (T, E) combine weights, w[t, r] at column idx[t, r]
// and +0 elsewhere, in float32 or bfloat16 (round to nearest even).
//
// What bounds it on the H100: neither bytes nor operations.  A token
// reads E logits and writes 2k numbers and an E-wide row (OLMoE: 64
// float32 in, 8 + 8 out, 64 bf16 out), and its work is E exponentials
// and k warp reductions; at the serving shapes (4 tokens a decode step,
// 1,024 a prefill) the launch costs more than the work.  So the design
// takes the work of the launches around it and cuts the latency inside
// it.  Built by the caller, the dense combine weights take four more
// launches (zeros, idx.long(), scatter_, cast); here a lane that holds
// expert e writes slot e of the row, weight or zero, so the warp writes
// the whole row once, coalesced, with no zero-fill pass.  The dense
// value of a chosen expert is the very float that is written to w_out
// (the same bv, divided by the same sum), so the row equals the scatter
// of the kernel's own w and idx bit for bit.  It is an ordinary launch:
// programmatic dependent launch behind the cuBLAS logits product gained
// nothing on the H100 and cost a little in a CUDA graph (PERF.md).
//
// Inside: one warp per token, expert e held by lane e % 32 in slot e / 32
// (two slots a lane for E = 64; the slot count S is a template argument,
// the least power of two with 32 S >= E, so no lane walks empty slots).
// The softmax max is one warp-wide integer max (`redux.sync`, i.e.
// __reduce_max_sync, sm_80 and later) over order-preserving bits, the
// sum a shuffle reduction.  Each of the k rounds is two `redux.sync`s,
// not five shuffle stages of (value, index) pairs: a probability
// p >= 0 orders as its bits, so the round's winning value is the
// integer max of key = bits(p) + 1 (0 for a taken or absent expert),
// and the winner the integer min of the indices holding it, the lowest
// index winning a tie as in `_route_kernel`.  There is no padding of E
// or of the token count: lanes past E hold key 0 and write nothing, and
// warps past the last token return at once.  The TPU shaping (E padded
// to 128 lanes, 256-token blocks) is gone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define EMAX 512   // experts a token may have: 16 register slots a lane
#define KMAX 64    // experts a token may choose

namespace {

constexpr int kWarps = 8;               // tokens per block
constexpr int kThreads = 32 * kWarps;
constexpr int kOut = KMAX / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_w(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_w(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A float's bits as an unsigned integer in the float's order (-0 just
// below +0), and back: the warp max of floats is one integer redux.
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ float warp_max(float x) {
  return unordered(__reduce_max_sync(kFull, ordered(x)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T, typename D, int S>
__global__ void __launch_bounds__(kThreads)
route_kernel(const T* __restrict__ logits, float* __restrict__ w_out,
             int* __restrict__ i_out, D* __restrict__ dense, int n_tok,
             int E, int k, int renormalize) {
  const int lane = threadIdx.x & 31;
  const int tok = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tok >= n_tok) return;              // the whole warp leaves together
  const T* row = logits + (size_t)tok * E;

  // softmax over the E logits, float32
  float p[S];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? load_f32(row + e) : -INFINITY;
    m = fmaxf(m, p[j]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (lane + 32 * j < E) {
      p[j] = expf(p[j] - m);
      s += p[j];
    }
  }
  s = warp_sum(s);
  // key: bits(p) + 1 orders as p for p >= 0; 0 = absent or taken
  unsigned key[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    p[j] = p[j] / s;
    key[j] = lane + 32 * j < E ? __float_as_uint(p[j]) + 1u : 0u;
  }

  // k rounds: the warp's largest key, the lowest index holding it, then
  // take it.  chosen[j] keeps the weight of slot j's expert if it won.
  float my_w[kOut];
  int my_i[kOut];
  float chosen[S];
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    my_w[i] = 0.f;
    my_i[i] = 0;
  }
#pragma unroll
  for (int j = 0; j < S; ++j) chosen[j] = 0.f;
  for (int r = 0; r < k; ++r) {
    unsigned best = key[0];
    int bj = 0;
#pragma unroll
    for (int j = 1; j < S; ++j)         // slots ascend in index: strict >
      if (key[j] > best) {
        best = key[j];
        bj = j;
      }
    const unsigned top = __reduce_max_sync(kFull, best);
    const int bi = (int)__reduce_min_sync(
        kFull, best == top ? (unsigned)(lane + 32 * bj) : (unsigned)EMAX);
    const float bv = __uint_as_float(top - 1u);
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (lane + 32 * j == bi) {
        key[j] = 0u;
        chosen[j] = bv;
      }
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
#pragma unroll
    for (int j = 0; j < S; ++j) chosen[j] = chosen[j] / tot;  // 0 -> +0
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int r = lane + 32 * i;
    if (r < k) {
      w_out[(size_t)tok * k + r] = my_w[i];
      i_out[(size_t)tok * k + r] = my_i[i];
    }
  }
  if (dense != nullptr) {                // uniform over the grid
    D* drow = dense + (size_t)tok * E;
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (lane + 32 * j < E) store_w(drow + lane + 32 * j, chosen[j]);
  }
}

template <typename T, typename D, int S>
int launch_slots(const void* logits, void* w_out, void* i_out, void* dense,
                 int n_tok, int E, int k, int renormalize, cudaStream_t st) {
  route_kernel<T, D, S><<<(n_tok + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      (const T*)logits, (float*)w_out, (int*)i_out, (D*)dense, n_tok, E, k,
      renormalize);
  return (int)cudaGetLastError();
}

// The least slot count S (a power of two) with 32 S >= E.
template <typename T, typename D>
int launch_route(const void* logits, void* w_out, void* i_out, void* dense,
                 int n_tok, int E, int k, int renormalize, cudaStream_t st) {
  if (E <= 32)
    return launch_slots<T, D, 1>(logits, w_out, i_out, dense, n_tok, E, k,
                                 renormalize, st);
  if (E <= 64)
    return launch_slots<T, D, 2>(logits, w_out, i_out, dense, n_tok, E, k,
                                 renormalize, st);
  if (E <= 128)
    return launch_slots<T, D, 4>(logits, w_out, i_out, dense, n_tok, E, k,
                                 renormalize, st);
  if (E <= 256)
    return launch_slots<T, D, 8>(logits, w_out, i_out, dense, n_tok, E, k,
                                 renormalize, st);
  return launch_slots<T, D, EMAX / 32>(logits, w_out, i_out, dense, n_tok,
                                       E, k, renormalize, st);
}

}  // namespace

extern "C" int moe_route_emax() { return EMAX; }
extern "C" int moe_route_kmax() { return KMAX; }

// dtype: 0 = float32 logits, 1 = bfloat16 logits.  dense: null for no
// dense output, else a (n_tok, E) buffer of dense_dtype (0 = float32,
// 1 = bfloat16).  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int moe_route_launch(const void* logits, int dtype, void* w_out,
                                void* i_out, void* dense, int dense_dtype,
                                int n_tok, int E, int k, int renormalize,
                                void* stream) {
  if (E < 1 || E > EMAX || k < 1 || k > KMAX || k > E || n_tok < 0 ||
      (dtype != 0 && dtype != 1) ||
      (dense != nullptr && dense_dtype != 0 && dense_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n_tok == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool bf16_out = dense != nullptr && dense_dtype == 1;
  if (dtype == 0)
    return bf16_out
        ? launch_route<float, __nv_bfloat16>(logits, w_out, i_out, dense,
                                             n_tok, E, k, renormalize, st)
        : launch_route<float, float>(logits, w_out, i_out, dense, n_tok, E,
                                     k, renormalize, st);
  return bf16_out
      ? launch_route<__nv_bfloat16, __nv_bfloat16>(
            logits, w_out, i_out, dense, n_tok, E, k, renormalize, st)
      : launch_route<__nv_bfloat16, float>(logits, w_out, i_out, dense,
                                           n_tok, E, k, renormalize, st);
}
