// Hierarchical market-clearing pass for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/market_clear/kernel.py
// `clear_pallas` (body `_clear_kernel`, merge `_merge2_rows`).  It
// computes what repro_torch.kernels.market_clear.ref.clear_sorted_from_aggs
// computes, bit for bit: the function is comparisons, max and min only.
//
// Inputs are the segment-major ranked aggregates of `_prefix_aggregates`:
// (n_seg, k) lists pk/tk/sk/qk (price desc, seq asc, NEG/-1 padded) and
// the (n_seg,) fall-backs p2/t2/s2/q2 (best entry from a tenant other than
// the segment's top tenant), the per-segment operator floors, the owner
// and retention limit per leaf, and per level the stride and the global
// segment id of node 0.  Outputs per leaf: charged rate, winning level,
// the (k+1)-wide ranked slate with -1 holes, the truncation flag and the
// eviction mask.
//
// What bounds it on the H100: nothing the card is short of.  At the main
// path's shapes (n = 10,000 leaves, strides (1, 8, 32, 128, 10000), 11,643
// segments, k = 16) the unique bytes are about 4 MB (3.35 TB/s: ~1.2 us)
// and the work is a few thousand compares per leaf, so a launch (a few
// microseconds) costs more than the work.  The design is therefore the
// simplest correct one: one thread per leaf walks its ancestors root to
// leaf (node chain n[0] = leaf / stride[0], n[d+1] = n[d] * stride[d] /
// stride[d+1], the reference's parent map) and merges its running k-list
// with each ancestor's list by the reference's own k-pass selection
// (price desc, seq asc), carrying tenant, slot and originating level, and
// keeps the distinct-second-tenant fall-back exactly as `_merge2` does.
// Dead levels are merged too: merging an all-dead list is the identity,
// as the reference's skip relies on.  The TPU shaping (8/128 slab
// packing, BlockSpec node windows, `_pick_block`) is gone.  Neighbouring
// leaves share ancestors, so the ancestor rows are served from L1/L2.
// Per-thread lists live in local memory (L1-backed); k is a run-time
// argument up to KMAX.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KMAX 32
#define LMAX 16

namespace {

constexpr float NEG = -1e30f;
constexpr float HALF_NEG = -5e29f;   // NEG / 2 as the reference rounds it
constexpr float EPSF = 1e-6f;
constexpr int BIGS = 1 << 30;

struct Levels {
  int n_lvl;
  int stride[LMAX];
  int off[LMAX];
};

// jnp.max semantics: NaN propagates
__device__ __forceinline__ float nanmax(float a, float b) {
  if (a != a || b != b) return NAN;
  return a > b ? a : b;
}

struct Entry {
  float p;
  int t, s, q, l;
};

// One `_merge2` step for one row: A (the running path list) and B (this
// level's list), each k entries, plus their fall-backs.  The merged list
// is written back into A; the merged fall-back into a2.
__device__ void merge2(Entry* A, Entry& a2, const Entry* B, const Entry& b2,
                       int k) {
  float W[2 * KMAX];
  int Q[2 * KMAX];
  for (int j = 0; j < k; ++j) {
    W[j] = A[j].p;     Q[j] = A[j].q;
    W[k + j] = B[j].p; Q[k + j] = B[j].q;
  }
  const int ta0 = A[0].t, tb0 = B[0].t;
  const Entry ahead = A[0], bhead = B[0];
  Entry out[KMAX];
  for (int r = 0; r < k; ++r) {
    float pm = W[0];
    for (int j = 1; j < 2 * k; ++j) pm = nanmax(pm, W[j]);
    int qm = BIGS;
    for (int j = 0; j < 2 * k; ++j) {
      const bool cand = (W[j] > HALF_NEG) && (W[j] >= pm);
      if (cand && Q[j] < qm) qm = Q[j];
    }
    int mt = -1, ms = -1, ml = -1;
    for (int j = 0; j < 2 * k; ++j) {
      const bool sel = (W[j] > HALF_NEG) && (W[j] >= pm) && (Q[j] == qm);
      if (sel) {
        const Entry* e = j < k ? &A[j] : &B[j - k];
        mt = max(mt, e->t);
        ms = max(ms, e->s);
        ml = max(ml, e->l);
        W[j] = NEG;
      }
    }
    const bool alive = pm > HALF_NEG;
    out[r].p = alive ? pm : NEG;
    out[r].q = alive ? qm : -1;
    out[r].t = mt;
    out[r].s = ms;
    out[r].l = ml;
  }
  const int t0 = out[0].t;
  const Entry cA = (ta0 == t0) ? a2 : ahead;
  const Entry cB = (tb0 == t0) ? b2 : bhead;
  const bool a_wins = (cA.p > cB.p) || ((cA.p == cB.p) && (cA.q < cB.q));
  a2 = a_wins ? cA : cB;
  for (int r = 0; r < k; ++r) A[r] = out[r];
}

__device__ void load_level(int seg, int d, int k, const float* pk,
                           const int* tk, const int* sk, const int* qk,
                           const float* p2, const int* t2, const int* s2,
                           const int* q2, Entry* L, Entry& f) {
  const int64_t base = (int64_t)seg * k;
  for (int j = 0; j < k; ++j) {
    L[j].p = pk[base + j];
    L[j].t = tk[base + j];
    L[j].s = sk[base + j];
    L[j].q = qk[base + j];
    L[j].l = L[j].p > HALF_NEG ? d : -1;
  }
  f.p = p2[seg];
  f.t = t2[seg];
  f.s = s2[seg];
  f.q = q2[seg];
  f.l = f.p > HALF_NEG ? d : -1;
}

__global__ void clear_kernel(const float* __restrict__ pk,
                             const int* __restrict__ tk,
                             const int* __restrict__ sk,
                             const int* __restrict__ qk,
                             const float* __restrict__ p2,
                             const int* __restrict__ t2,
                             const int* __restrict__ s2,
                             const int* __restrict__ q2,
                             const float* __restrict__ floor_seg,
                             const int* __restrict__ owner,
                             const float* __restrict__ limit,
                             Levels lv, int n_leaves, int k,
                             float* __restrict__ rate,
                             int* __restrict__ best_level,
                             int* __restrict__ cand_slots,
                             int* __restrict__ truncated,
                             int* __restrict__ evict) {
  const int leaf = blockIdx.x * blockDim.x + threadIdx.x;
  if (leaf >= n_leaves) return;
  const int n_lvl = lv.n_lvl;

  // ancestor chain by the reference's parent map
  int node[LMAX];
  node[0] = leaf / lv.stride[0];
  for (int d = 0; d + 1 < n_lvl; ++d)
    node[d + 1] = (int)(((int64_t)node[d] * lv.stride[d]) / lv.stride[d + 1]);

  Entry path[KMAX], lvl[KMAX];
  Entry path2, f2;
  const int top = n_lvl - 1;
  load_level(lv.off[top] + node[top], top, k, pk, tk, sk, qk, p2, t2, s2,
             q2, path, path2);
  for (int d = n_lvl - 2; d >= 0; --d) {
    load_level(lv.off[d] + node[d], d, k, pk, tk, sk, qk, p2, t2, s2, q2,
               lvl, f2);
    merge2(path, path2, lvl, f2, k);
  }

  // path floor: max over levels of the floor of leaf // stride[d]
  float floor = 0.0f;
  for (int d = 0; d < n_lvl; ++d)
    floor = nanmax(floor, floor_seg[lv.off[d] + leaf / lv.stride[d]]);

  const int own = owner[leaf];
  const bool has_owner = own >= 0;
  bool all_owned = has_owner && (path[0].p > HALF_NEG);
  for (int j = 0; j < k; ++j) {
    const bool live = path[j].p > HALF_NEG;
    const bool excl = has_owner && path[j].t == own;
    all_owned = all_owned && (!live || excl);
  }
  float E[KMAX + 1];
  int ES[KMAX + 1], EL[KMAX + 1];
  for (int j = 0; j < k; ++j) {
    const bool excl = has_owner && path[j].t == own;
    E[j] = excl ? NEG : path[j].p;
    ES[j] = path[j].s;
    EL[j] = path[j].l;
  }
  E[k] = all_owned ? path2.p : NEG;
  ES[k] = path2.s;
  EL[k] = path2.l;

  float top_p = E[0];
  for (int j = 1; j <= k; ++j) top_p = nanmax(top_p, E[j]);
  const float r = nanmax(floor, nanmax(top_p, 0.0f));
  int col0 = 0;
  for (int j = k; j >= 0; --j)
    if (E[j] >= top_p && E[j] > HALF_NEG) col0 = j;
  rate[leaf] = r;
  best_level[leaf] = top_p > HALF_NEG ? EL[col0] : -1;
  const float fl = floor - EPSF;
  int* slate = cand_slots + (int64_t)leaf * (k + 1);
  for (int j = 0; j <= k; ++j)
    slate[j] = (E[j] > HALF_NEG && E[j] >= fl) ? ES[j] : -1;
  truncated[leaf] =
      (path[k - 1].p > HALF_NEG && path[k - 1].p >= fl) ? 1 : 0;
  evict[leaf] = (has_owner && r > limit[leaf] + EPSF) ? 1 : 0;
}

}  // namespace

extern "C" int market_clear_kmax() { return KMAX; }
extern "C" int market_clear_lmax() { return LMAX; }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int market_clear_launch(
    const float* pk, const int* tk, const int* sk, const int* qk,
    const float* p2, const int* t2, const int* s2, const int* q2,
    const float* floor_seg, const int* owner, const float* limit,
    const int* strides, const int* level_off, int n_lvl, int n_leaves, int k,
    float* rate, int* best_level, int* cand_slots, int* truncated,
    int* evict, void* stream) {
  if (n_lvl < 1 || n_lvl > LMAX || k < 1 || k > KMAX || n_leaves < 0)
    return (int)cudaErrorInvalidValue;
  if (n_leaves == 0) return 0;
  Levels lv;
  lv.n_lvl = n_lvl;
  for (int d = 0; d < LMAX; ++d) {
    lv.stride[d] = d < n_lvl ? strides[d] : 1;
    lv.off[d] = d < n_lvl ? level_off[d] : 0;
  }
  const int threads = 128;
  const int blocks = (n_leaves + threads - 1) / threads;
  clear_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pk, tk, sk, qk, p2, t2, s2, q2, floor_seg, owner, limit, lv, n_leaves,
      k, rate, best_level, cand_slots, truncated, evict);
  return (int)cudaGetLastError();
}
