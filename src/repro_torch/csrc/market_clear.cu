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
// What bounds it on the H100: latency, not bytes or operations.  At the
// main path's shapes (n = 10,000 leaves, strides (1, 8, 32, 128, 10000),
// 11,643 segments, k = 16) the unique bytes are about 4 MB (3.35 TB/s:
// ~1.2 us) and the merges a few million compares.  What costs time is a
// chain of dependent steps: read the lists, merge level after level from
// the root down, then the leaf stage.  The design keeps that chain short
// and every step parallel (on an H100 SXM at 700 W: 0.0144 ms a call in a
// CUDA graph, 11.7x the byte bound; the thread-per-leaf design took
// 0.127 ms):
//
// * A block per leaf range (`leaves_per_block` leaves: 32 from the
//   wrapper, 313 blocks at 10,000 leaves, two or more an SM).  The
//   reference's parent map n[d+1] = n[d]*stride[d] / stride[d+1] is
//   monotone, so a range's ancestors at each level are one contiguous
//   node range; the wrapper's table gives each block its
//   (first node, count, staging offset) per level.  Beside that row the
//   block reads its leaves' owners, limits and path floors, then copies
//   all its nodes' lists into shared memory with cp.async at once (one
//   round trip), then walks the levels root to leaf, merging each node
//   of its range once, with __syncthreads() between levels.  A node
//   near the root is merged again by every block under it: a few merges
//   a block instead of one per leaf per level.
// * One warp per node merge.  Lane j holds entry j of the 2k candidates
//   (A, the parent's path, then B, the node's own list); for k > 16 a
//   lane holds entries j and j + 32.  An entry's output rank is the
//   number of distinct live (price, seq) keys strictly better than its
//   own (price desc, seq asc), counted over one leader per key
//   (__match_any_sync).  Equal keys collapse into one output that takes
//   the group's maximum tenant, slot and level (shared-memory atomicMax),
//   as the reference's k-pass selection collapses them.  A NaN among the
//   2k prices makes every output dead, as the selection's NaN-propagating
//   max does.  A zero price takes the bits of the highest-index remaining
//   entry equal to it, the selection's max fold in index order, so -0.0
//   and +0.0 come out as before.  The fall-back is merged as `_merge2`
//   merges it.  Live seqs are below 2^30, the selection's BIGS sentinel,
//   as the engine's arrival counter keeps them.
// * A node whose own list is dead is not merged when the merge would be
//   the identity: `merge_is_identity` checks, in a few warp votes, that
//   the parent's path is already a canonical ranked list (live prefix,
//   strictly ordered keys, exact dead tail, one sign of zero, no NaN) and
//   that the fall-back would be kept.  Then the node takes its parent's
//   path; otherwise it is merged.  Most level-0 lists are dead.
// * The leaf stage runs one warp per leaf, lane j on slate column j:
//   warp votes and one warp max (`__reduce_max_sync` over the prices as
//   order-preserving ints) give all_owned, the best price and the first
//   column that reaches it, and the lanes store the slate row in one
//   coalesced store.
//
// Nothing lives in local memory: per-lane state is a few registers, and
// paths, staged lists and per-leaf values are in shared memory, sized by
// the plan (16.6 KB a block on the main path, 31.7 KB at k = 32); a plan
// that needs more than 48 KB opts in at launch, one past the card's limit
// is refused.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define KMAX 32
#define LMAX 16

namespace {

constexpr float NEG = -1e30f;
constexpr float HALF_NEG = -5e29f;   // NEG / 2 as the reference rounds it
constexpr float EPSF = 1e-6f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

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

// A float's bits as an int that orders as the float does (not NaN).
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_order_key(int b) {
  return __int_as_float(b ^ ((b >> 31) & 0x7fffffff));
}

struct Ent {
  float p;
  int t, s, q, l;
};

__device__ __forceinline__ bool better(float p1, int q1, float p2, int q2) {
  return p1 > p2 || (p1 == p2 && q1 < q2);
}

__device__ __forceinline__ bool same_bits(const Ent& a, const Ent& b) {
  return __float_as_int(a.p) == __float_as_int(b.p) && a.t == b.t &&
         a.s == b.s && a.q == b.q && a.l == b.l;
}

// A path in shared memory, 5k + 5 words: prices (as bits), tenants,
// slots, seqs, levels, then the fall-back (p, t, s, q, l).
__device__ __forceinline__ int slot_words(int k) { return 5 * k + 5; }

__device__ __forceinline__ Ent slot_entry(const int* sl, int k, int j) {
  return {__int_as_float(sl[j]), sl[k + j], sl[2 * k + j], sl[3 * k + j],
          sl[4 * k + j]};
}

__device__ __forceinline__ Ent slot_fallback(const int* sl, int k) {
  const int* f = sl + 5 * k;
  return {__int_as_float(f[0]), f[1], f[2], f[3], f[4]};
}

// A node's own list and fall-back, staged in shared memory.
struct Own {
  const float* p;
  const int *t, *s, *q;
  const float* p2;
  const int *t2, *s2, *q2;
};

__device__ __forceinline__ Ent own_entry(const Own& o, int node, int k,
                                         int j, int d) {
  const int i = node * k + j;
  const float p = o.p[i];
  return {p, o.t[i], o.s[i], o.q[i], p > HALF_NEG ? d : -1};
}

__device__ __forceinline__ Ent own_fallback(const Own& o, int node, int d) {
  const float p = o.p2[node];
  return {p, o.t2[node], o.s2[node], o.q2[node], p > HALF_NEG ? d : -1};
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Entry e of a merge: A[e] (the parent's path) for e < k, B[e - k] (the
// node's own list) for e < 2k, dead beyond.
__device__ __forceinline__ Ent merge_input(int e, int k, const int* A,
                                           const Own& o, int node, int d) {
  if (e < k) return slot_entry(A, k, e);
  if (e < 2 * k) return own_entry(o, node, k, e - k, d);
  return {NEG, -1, -1, -1, -1};
}

// True when merging A with this node's list is the identity on A and its
// fall-back: B is dead (every price <= NEG/2, so no NaN), A has no NaN,
// its live entries are a prefix in strictly decreasing (price, seq) order
// with payloads >= -1, its dead entries are exactly (NEG, -1, -1, -1, -1),
// its zero prices share one sign, and the merged fall-back is A's.  A is
// in lanes 0..k-1 of register 0 (k <= 32).
template <int NR>
__device__ bool merge_is_identity(const Ent (&x)[NR], int k, const Ent& a2,
                                  const Ent& b0, const Ent& b2) {
  const int lane = threadIdx.x & 31;
  bool bad = false;
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    const int e = lane + 32 * h;
    if (e >= k && e < 2 * k) bad |= !(x[h].p <= HALF_NEG);
  }
  const Ent& a = x[0];
  const bool is_a = lane < k;
  const bool live = is_a && a.p > HALF_NEG;
  const unsigned lm = __ballot_sync(FULL, live);
  const float pn = __shfl_down_sync(FULL, a.p, 1);
  const int qn = __shfl_down_sync(FULL, a.q, 1);
  const bool next_live = lane < 31 && ((lm >> (lane + 1)) & 1u);
  if (live) {
    bad |= next_live && !better(a.p, a.q, pn, qn);
    bad |= a.t < -1 || a.s < -1 || a.l < -1;
  } else if (is_a) {
    bad |= !same_bits(a, Ent{NEG, -1, -1, -1, -1});
  }
  const bool zero = live && a.p == 0.0f;
  const unsigned zneg = __ballot_sync(FULL, zero && signbit(a.p));
  const unsigned zpos = __ballot_sync(FULL, zero && !signbit(a.p));
  if (__any_sync(FULL, bad) || (lm & (lm + 1u)) != 0u || (zneg && zpos))
    return false;
  // the fall-back: t0 = A[0].t (or -1 when A is dead) picks a2 on A's
  // side; it must beat (or equal) B's candidate
  const int t0 = lm ? __shfl_sync(FULL, a.t, 0) : -1;
  const Ent cB = (b0.t == t0) ? b2 : b0;
  return (a2.p > cB.p || (a2.p == cB.p && a2.q < cB.q)) ||
         same_bits(a2, cB);
}

// One `_merge2` of the warp's 2k entries into `out`: the exact top-k by
// (price desc, seq asc) with equal keys collapsed, dead ranks
// (NEG, -1, -1, -1, -1), and the fall-back.
template <int NR>
__device__ void merge_into(const Ent (&x)[NR], int k, const Ent& a0,
                           const Ent& a2, const Ent& b0, const Ent& b2,
                           int* out) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  bool has_nan = false;
#pragma unroll
  for (int h = 0; h < NR; ++h) has_nan |= (x[h].p != x[h].p);
  has_nan = __any_sync(FULL, has_nan);
  bool live[NR];
  int rank[NR];
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    live[h] = !has_nan && x[h].p > HALF_NEG;
    rank[h] = 0;
  }
  // leaders: the lowest-index live entry of each distinct key; -0.0 and
  // +0.0 are one price
  bool lead[NR];
  unsigned long long key[NR];
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    const float pc = x[h].p == 0.0f ? 0.0f : x[h].p;
    key[h] = ((unsigned long long)__float_as_uint(pc) << 32) |
             (unsigned)x[h].q;
  }
  // the count loops do not branch, so their 64 shuffles pipeline
  const unsigned m0 = __match_any_sync(FULL, key[0]);
  lead[0] = live[0] && !(m0 & lt);
  const unsigned lead0 = __ballot_sync(FULL, lead[0]);
  bool dup1 = false;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float pj = __shfl_sync(FULL, x[0].p, j);
    const int qj = __shfl_sync(FULL, x[0].q, j);
    const bool lj = (lead0 >> j) & 1u;
#pragma unroll
    for (int h = 0; h < NR; ++h)
      rank[h] += lj && better(pj, qj, x[h].p, x[h].q);
    if (NR == 2) dup1 |= lj && pj == x[NR - 1].p && qj == x[NR - 1].q;
  }
  if (NR == 2) {
    const unsigned m1 = __match_any_sync(FULL, key[NR - 1]);
    lead[NR - 1] = live[NR - 1] && !(m1 & lt) && !dup1;
    const unsigned lead1 = __ballot_sync(FULL, lead[NR - 1]);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float pj = __shfl_sync(FULL, x[NR - 1].p, j);
      const int qj = __shfl_sync(FULL, x[NR - 1].q, j);
      const bool lj = (lead1 >> j) & 1u;
#pragma unroll
      for (int h = 0; h < NR; ++h)
        rank[h] += lj && better(pj, qj, x[h].p, x[h].q);
    }
  }
  // a zero price takes the bits of the highest-index remaining entry
  // equal to it (the selection's max fold keeps the last of equals)
  float pout[NR];
  unsigned zm[NR];
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    pout[h] = x[h].p;
    zm[h] = __ballot_sync(FULL, live[h] && x[h].p == 0.0f);
  }
#pragma unroll
  for (int g = 0; g < NR; ++g) {
    for (unsigned z = zm[g]; z; z &= z - 1u) {
      const int j = __ffs(z) - 1;
      const float pj = __shfl_sync(FULL, x[g].p, j);
      const int qj = __shfl_sync(FULL, x[g].q, j);
#pragma unroll
      for (int h = 0; h < NR; ++h)
        if (x[h].p == 0.0f && qj >= x[h].q) pout[h] = pj;
    }
  }
  for (int r = lane; r < k; r += 32) {
    out[r] = __float_as_int(NEG);
    out[k + r] = -1;
    out[2 * k + r] = -1;
    out[3 * k + r] = -1;
    out[4 * k + r] = -1;
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    if (live[h] && rank[h] < k) {
      const int r = rank[h];
      atomicMax(&out[k + r], x[h].t);
      atomicMax(&out[2 * k + r], x[h].s);
      atomicMax(&out[4 * k + r], x[h].l);
      if (lead[h]) {
        out[r] = __float_as_int(pout[h]);
        out[3 * k + r] = x[h].q;
      }
    }
  }
  __syncwarp();
  if (lane == 0) {
    const int t0 = out[k];
    const Ent cA = (a0.t == t0) ? a2 : a0;
    const Ent cB = (b0.t == t0) ? b2 : b0;
    const bool a_wins = cA.p > cB.p || (cA.p == cB.p && cA.q < cB.q);
    const Ent f = a_wins ? cA : cB;
    int* o = out + 5 * k;
    o[0] = __float_as_int(f.p);
    o[1] = f.t;
    o[2] = f.s;
    o[3] = f.q;
    o[4] = f.l;
  }
  __syncwarp();
}

__device__ void copy_slot(const int* src, int* dst, int k) {
  const int lane = threadIdx.x & 31;
  for (int w = lane; w < slot_words(k); w += 32) dst[w] = src[w];
  __syncwarp();
}

// The path of node `node` (own-list index) at level d < top, from its
// parent's path A: A itself when merging is the identity and `alias` is
// set, else written to `out`.
template <int NR>
__device__ const int* node_path(const int* A, const Own& o, int node, int d,
                                int k, int* out, bool alias) {
  const int lane = threadIdx.x & 31;
  Ent x[NR];
#pragma unroll
  for (int h = 0; h < NR; ++h)
    x[h] = merge_input(lane + 32 * h, k, A, o, node, d);
  const Ent a0 = slot_entry(A, k, 0);
  const Ent a2 = slot_fallback(A, k);
  const Ent b0 = own_entry(o, node, k, 0, d);
  const Ent b2 = own_fallback(o, node, d);
  if (merge_is_identity<NR>(x, k, a2, b0, b2)) {
    if (alias) return A;
    copy_slot(A, out, k);
    return out;
  }
  merge_into<NR>(x, k, a0, a2, b0, b2, out);
  return out;
}

// The root level's paths are its own lists, levels attached.
__device__ void root_path(const Own& o, int node, int d, int k, int* out) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < k; j += 32) {
    const Ent e = own_entry(o, node, k, j, d);
    out[j] = __float_as_int(e.p);
    out[k + j] = e.t;
    out[2 * k + j] = e.s;
    out[3 * k + j] = e.q;
    out[4 * k + j] = e.l;
  }
  if (lane == 0) {
    const Ent f = own_fallback(o, node, d);
    int* w = out + 5 * k;
    w[0] = __float_as_int(f.p);
    w[1] = f.t;
    w[2] = f.s;
    w[3] = f.q;
    w[4] = f.l;
  }
  __syncwarp();
}

// Owner exclusion, floors, slate, truncation and eviction for one leaf,
// one warp: column c = lane + 32h of the (k+1)-wide slate.
template <int NR>
__device__ void leaf_stage(const int* path, int k, int64_t leaf, int own,
                           float lim, float floor, float* rate,
                           int* best_level, int* cand_slots, int* truncated,
                           int* evict) {
  const int lane = threadIdx.x & 31;
  const bool has_owner = own >= 0;
  float E[NR];
  int ES[NR], EL[NR];
  bool not_owned = false;     // a live merged entry the owner does not hold
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    const int c = lane + 32 * h;
    E[h] = NEG;
    ES[h] = -1;
    EL[h] = -1;
    if (c < k) {
      const Ent e = slot_entry(path, k, c);
      const bool excl = has_owner && e.t == own;
      not_owned |= (e.p > HALF_NEG) && !excl;
      E[h] = excl ? NEG : e.p;
      ES[h] = e.s;
      EL[h] = e.l;
    }
  }
  const float p0 = __int_as_float(path[0]);
  const bool all_owned =
      has_owner && p0 > HALF_NEG && !__any_sync(FULL, not_owned);
  const Ent f = slot_fallback(path, k);
  bool nan = false;
  int mx = INT_MIN;           // the max as an order-preserving int key
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    const int c = lane + 32 * h;
    if (c == k) {
      E[h] = all_owned ? f.p : NEG;
      ES[h] = f.s;
      EL[h] = f.l;
    }
    if (c <= k) {
      nan |= E[h] != E[h];
      mx = max(mx, order_key(E[h]));
    }
  }
  // the value of the NaN-propagating max; the sign of a zero maximum
  // reaches no output (rate takes max(top_p, +0.0))
  const int top_key = __reduce_max_sync(FULL, mx);
  const float top_p = __any_sync(FULL, nan) ? NAN : from_order_key(top_key);
  int col0 = -1;
#pragma unroll
  for (int h = NR - 1; h >= 0; --h) {
    const int c = lane + 32 * h;
    const unsigned b = __ballot_sync(
        FULL, c <= k && E[h] >= top_p && E[h] > HALF_NEG);
    if (b) col0 = 32 * h + __ffs(b) - 1;
  }
  if (col0 < 0) col0 = 0;
  int bl = -1;
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    const int v = __shfl_sync(FULL, EL[h], col0 & 31);
    if ((col0 >> 5) == h) bl = v;
  }
  const float r = nanmax(floor, nanmax(top_p, 0.0f));
  const float fl = floor - EPSF;
  int* slate = cand_slots + leaf * (k + 1);
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    const int c = lane + 32 * h;
    if (c <= k) slate[c] = (E[h] > HALF_NEG && E[h] >= fl) ? ES[h] : -1;
  }
  if (lane == 0) {
    const float pk1 = __int_as_float(path[k - 1]);
    rate[leaf] = r;
    best_level[leaf] = top_p > HALF_NEG ? bl : -1;
    truncated[leaf] = (pk1 > HALF_NEG && pk1 >= fl) ? 1 : 0;
    evict[leaf] = (has_owner && r > lim + EPSF) ? 1 : 0;
  }
}

__device__ __forceinline__ int parent_of(int node, int sd, int sd1) {
  return (int)(((long long)node * sd) / sd1);
}

// Shared memory of one block, in 4-byte words: the plan row (3 LMAX),
// owner/limit/floor per leaf (3 L), a path scratch per warp, two path
// buffers of `max_hi` nodes, and the staged own lists of `own_max` nodes
// (4k + 4 words each).
inline long long smem_words(int k, int L, int max_hi,
                                                int own_max) {
  return 3LL * LMAX + 3LL * L + (WARPS + 2LL * max_hi) * (5LL * k + 5) +
         (long long)own_max * (4 * k + 4);
}

template <int NR>
__global__ void __launch_bounds__(THREADS)
    clear_tree_kernel(const float* __restrict__ pk,
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
                      const int* __restrict__ plan, Levels lv, int n_leaves,
                      int k, int L, int max_hi, int own_max,
                      float* __restrict__ rate,
                      int* __restrict__ best_level,
                      int* __restrict__ cand_slots,
                      int* __restrict__ truncated,
                      int* __restrict__ evict) {
  extern __shared__ int smem[];
  const int n_lvl = lv.n_lvl;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int first = blockIdx.x * L;
  const int nl = min(L, n_leaves - first);
  const int sw = slot_words(k);

  int* lo = smem;                      // per level: first node
  int* cnt = lo + LMAX;                // node count
  int* soff = cnt + LMAX;              // staging offset (nodes)
  int* sh_owner = soff + LMAX;
  float* sh_limit = reinterpret_cast<float*>(sh_owner + L);
  float* sh_floor = sh_limit + L;
  int* scratch = reinterpret_cast<int*>(sh_floor + L) + warp * sw;
  int* buf0 = reinterpret_cast<int*>(sh_floor + L) + WARPS * sw;
  int* buf1 = buf0 + max_hi * sw;
  float* own_p = reinterpret_cast<float*>(buf1 + max_hi * sw);
  int* own_t = reinterpret_cast<int*>(own_p + own_max * k);
  int* own_s = own_t + own_max * k;
  int* own_q = own_s + own_max * k;
  float* own_p2 = reinterpret_cast<float*>(own_q + own_max * k);
  int* own_t2 = reinterpret_cast<int*>(own_p2 + own_max);
  int* own_s2 = own_t2 + own_max;
  int* own_q2 = own_s2 + own_max;

  // the plan row, and per leaf its owner, limit and path floor (the
  // floor of each ancestor leaf // stride[d], folded in level order)
  const int* row = plan + (int64_t)blockIdx.x * 3 * n_lvl;
  if (tid < 3 * n_lvl) lo[(tid / n_lvl) * LMAX + tid % n_lvl] = row[tid];
  if (tid < nl) {
    const int leaf = first + tid;
    sh_owner[tid] = owner[leaf];
    sh_limit[tid] = limit[leaf];
    float fv[LMAX];
#pragma unroll
    for (int d = 0; d < LMAX; ++d)
      if (d < n_lvl) fv[d] = floor_seg[lv.off[d] + leaf / lv.stride[d]];
    float floor = 0.0f;
#pragma unroll
    for (int d = 0; d < LMAX; ++d)
      if (d < n_lvl) floor = nanmax(floor, fv[d]);
    sh_floor[tid] = floor;
  }
  __syncthreads();

  // stage every level's lists of this block's nodes
  for (int d = 0; d < n_lvl; ++d) {
    const int64_t g = lv.off[d] + lo[d];
    const int n = cnt[d] * k, so = soff[d];
    for (int e = tid; e < n; e += THREADS) {
      const int64_t src = g * k + e;
      const int dst = so * k + e;
      cp_async4(own_p + dst, pk + src);
      cp_async4(own_t + dst, tk + src);
      cp_async4(own_s + dst, sk + src);
      cp_async4(own_q + dst, qk + src);
    }
    for (int i = tid; i < cnt[d]; i += THREADS) {
      cp_async4(own_p2 + so + i, p2 + g + i);
      cp_async4(own_t2 + so + i, t2 + g + i);
      cp_async4(own_s2 + so + i, s2 + g + i);
      cp_async4(own_q2 + so + i, q2 + g + i);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const Own o{own_p, own_t, own_s, own_q, own_p2, own_t2, own_s2, own_q2};

  // root level: its own lists; then each level's nodes, root to leaf
  const int top = n_lvl - 1;
  {
    int* dst = (top & 1) ? buf1 : buf0;
    for (int i = warp; i < cnt[top]; i += WARPS)
      root_path(o, soff[top] + i, top, k, dst + i * sw);
  }
  __syncthreads();
  for (int d = top - 1; d >= 1; --d) {
    const int* pb = ((d + 1) & 1) ? buf1 : buf0;
    int* ob = (d & 1) ? buf1 : buf0;
    for (int i = warp; i < cnt[d]; i += WARPS) {
      const int par = parent_of(lo[d] + i, lv.stride[d], lv.stride[d + 1]) -
                      lo[d + 1];
      node_path<NR>(pb + par * sw, o, soff[d] + i, d, k, ob + i * sw, false);
    }
    __syncthreads();
  }

  // level 0 and the leaf stage: each warp takes a level-0 node, makes its
  // path (or finds it in the root level when there is one level) and
  // clears the node's leaves
  const int s0 = lv.stride[0];
  for (int i = warp; i < cnt[0]; i += WARPS) {
    const int node = lo[0] + i;
    const int* path;
    if (top == 0) {
      path = buf0 + i * sw;
    } else {
      const int par = parent_of(node, s0, lv.stride[1]) - lo[1];
      path = node_path<NR>(buf1 + par * sw, o, soff[0] + i, 0, k, scratch,
                           true);
    }
    const int l0 = max(first, node * s0);
    const int l1 = min(first + nl, node * s0 + s0);
    for (int leaf = l0; leaf < l1; ++leaf) {
      const int t = leaf - first;
      leaf_stage<NR>(path, k, leaf, sh_owner[t], sh_limit[t], sh_floor[t],
                     rate, best_level, cand_slots, truncated, evict);
    }
    __syncwarp();
  }
}

template <int NR>
int launch(const float* pk, const int* tk, const int* sk, const int* qk,
           const float* p2, const int* t2, const int* s2, const int* q2,
           const float* floor_seg, const int* owner, const float* limit,
           const int* plan, const Levels& lv, int n_leaves, int k, int L,
           int max_hi, int own_max, size_t smem, float* rate,
           int* best_level, int* cand_slots, int* truncated, int* evict,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        clear_tree_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_leaves + L - 1) / L;
  clear_tree_kernel<NR><<<blocks, THREADS, smem, stream>>>(
      pk, tk, sk, qk, p2, t2, s2, q2, floor_seg, owner, limit, plan, lv,
      n_leaves, k, L, max_hi, own_max, rate, best_level, cand_slots,
      truncated, evict);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int market_clear_kmax() { return KMAX; }
extern "C" int market_clear_lmax() { return LMAX; }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// `plan` is the device table of `leaves_per_block`-leaf blocks, (first
// node, count, staging offset) per level; `max_hi` the most nodes of one
// level above level 0 (of level 0 when it is the root) and `own_max` the
// most nodes over all levels that any block stages.
extern "C" int market_clear_launch(
    const float* pk, const int* tk, const int* sk, const int* qk,
    const float* p2, const int* t2, const int* s2, const int* q2,
    const float* floor_seg, const int* owner, const float* limit,
    const int* plan, const int* strides, const int* level_off, int n_lvl,
    int n_leaves, int k, int leaves_per_block, int max_hi, int own_max,
    float* rate, int* best_level, int* cand_slots, int* truncated,
    int* evict, void* stream) {
  if (n_lvl < 1 || n_lvl > LMAX || k < 1 || k > KMAX || n_leaves < 0 ||
      leaves_per_block < 1 || max_hi < 1 || own_max < n_lvl)
    return (int)cudaErrorInvalidValue;
  if (n_leaves == 0) return 0;
  // the most shared memory a block may opt into on this device
  int dev = 0, cap = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const long long smem = 4 * smem_words(k, leaves_per_block, max_hi,
                                        own_max);
  if (smem > cap) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n_lvl = n_lvl;
  for (int d = 0; d < LMAX; ++d) {
    lv.stride[d] = d < n_lvl ? strides[d] : 1;
    lv.off[d] = d < n_lvl ? level_off[d] : 0;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16)
    return launch<1>(pk, tk, sk, qk, p2, t2, s2, q2, floor_seg, owner, limit,
                     plan, lv, n_leaves, k, leaves_per_block, max_hi,
                     own_max, (size_t)smem, rate, best_level, cand_slots,
                     truncated, evict, st);
  return launch<2>(pk, tk, sk, qk, p2, t2, s2, q2, floor_seg, owner, limit,
                   plan, lv, n_leaves, k, leaves_per_block, max_hi, own_max,
                   (size_t)smem, rate, best_level, cand_slots, truncated,
                   evict, st);
}
