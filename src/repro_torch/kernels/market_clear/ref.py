"""Plain PyTorch version of the hierarchical market-clearing pass over
the sort-once segmented order book — the twin of
``repro.kernels.market_clear.ref`` (same functions, same contract,
bit-identical results).

The bid table is viewed through a segment-sorted permutation under the
key ``(segment asc, price desc, seq asc)``; a segment is one
(level, node) book.  ``_prefix_aggregates`` turns the view into
segment-major ``(n_seg, k)`` ranked lists plus the best entry from a
tenant other than the segment's top tenant, and
``clear_sorted_from_aggs`` merges those lists down the tree, root to
leaf, and applies owner exclusion, floors and the slate for every leaf.
The CUDA kernel (``kernel.py``, ``csrc/market_clear.cu``) computes
``clear_sorted_from_aggs``; this module is its plain version, which the
CPU path runs and the card checks the kernel against.

Tie-breaks are price desc, then ``seq`` asc (true arrival order).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.device import arange32, f32_order_key, i32, scatter_drop

NEG = -1e30
EPSF = 1e-6
BIGS = 1 << 30              # slot/seq sentinel above any real value

# per-leaf health lattice: UP clears normally; DRAINING accepts no new
# owners but honors existing retention limits; DOWN additionally
# force-evicts its owner (BatchEngine.step)
HEALTH_UP = 0
HEALTH_DRAINING = 1
HEALTH_DOWN = 2


def leaf_floor(level_floor: Sequence[torch.Tensor], strides: Sequence[int],
               n_leaves: int, device) -> torch.Tensor:
    """Per-leaf path floor: the max of every ancestor's operator floor."""
    leaf = torch.arange(n_leaves, device=device)
    floor = torch.zeros((n_leaves,), dtype=torch.float32, device=device)
    for d, s in enumerate(strides):
        floor = torch.maximum(floor, level_floor[d][leaf // s])
    return floor


def apply_health_mask(health, rate, best_level, cand_slots, truncated,
                      evict, level_floor, strides, owner, limit):
    """Post-clearing health mask, applied once after either version of
    the pass: non-``UP`` leaves get all-hole slates, a cleared
    ``truncated``, the floor-only rate and a floor-pressure-only
    eviction mask."""
    floor = leaf_floor(level_floor, strides, owner.shape[0], owner.device)
    not_up = health != HEALTH_UP
    cand_slots = torch.where(not_up[:, None], -1, cand_slots)
    truncated = torch.where(not_up, 0, truncated)
    rate = torch.where(not_up, torch.clamp_min(floor, 0.0), rate)
    best_level = torch.where(not_up, -1, best_level)
    evict = torch.where(
        not_up, i32((owner >= 0) & (rate > limit + EPSF)), evict)
    return rate, best_level, cand_slots, truncated, evict


def sort_book(gseg: torch.Tensor, prices: torch.Tensor,
              seqs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table sorted by ``(segment asc, price desc, seq asc)``.

    Two stable sorts, least significant key first: by seq, then by one
    int64 key holding the segment above the negated price's
    ``f32_order_key`` (the order ``lax.sort`` gives floats).  Returns
    ``(order, sorted_gseg)`` as int32."""
    perm = torch.sort(seqs, stable=True).indices
    neg_key = f32_order_key(torch.neg(prices)).long() + (1 << 31)
    key = (gseg.long() << 32) | neg_key
    perm = perm[torch.sort(key[perm], stable=True).indices]
    return i32(perm), gseg[perm]


def _prefix_aggregates(order, sorted_gseg, seg_start, prices, tenants,
                       seqs, n_seg: int, k: int):
    """Ranked per-segment aggregates as contiguous-prefix gathers — the
    producer both versions of the pass consume.

    Returns segment-major ``(n_seg, k)`` ranked lists ``(pk, tk, sk,
    qk)`` (price desc, seq asc; NEG/-1 past the live book) and the
    ``(n_seg,)`` fall-back ``(p2, t2, s2, q2)``: the best live entry from
    a tenant other than ``tk[:, 0]``.  The view may be stale in
    liveness only: killed entries are skipped by their live rank."""
    cap = order.shape[0]
    dev = order.device
    pos = arange32(cap, dev)
    o = order.long()
    p_s = prices[o]
    t_s = tenants[o]
    live = (p_s > NEG / 2) & (t_s >= 0) & (sorted_gseg < n_seg)
    g = sorted_gseg.clamp(0, n_seg - 1).long()
    # live rank within segment: cumsum minus the live count before it
    cum = torch.cumsum(i32(live), 0, dtype=torch.int32)
    ss = seg_start[:n_seg]
    before = torch.where(ss > 0, cum[(ss - 1).clamp_min(0).long()], 0)
    rank = cum - 1 - before[g]
    ok = live & (rank < k)
    flat = torch.where(ok, g * k + rank, n_seg * k)
    prefix_pos = scatter_drop(
        torch.full((n_seg * k,), cap, dtype=torch.int32, device=dev),
        flat, pos).view(n_seg, k)
    hit = prefix_pos < cap
    sl = order[prefix_pos.clamp(0, cap - 1).long()]
    sll = sl.long()
    pk = torch.where(hit, prices[sll], NEG)
    tk = torch.where(hit, tenants[sll], -1)
    sk = torch.where(hit, sl, -1)
    qk = torch.where(hit, seqs[sll], -1)
    # exact owner-exclusion fall-back: FIRST live entry from a tenant
    # other than the segment's top tenant (sorted order makes the
    # minimal position the (price desc, seq asc) best)
    alt = live & (t_s != tk[g, 0])
    pos2 = torch.full((n_seg + 1,), cap, dtype=torch.int32, device=dev)
    pos2 = pos2.scatter_reduce(0, torch.where(alt, g, n_seg),
                               torch.where(alt, pos, cap), "amin",
                               include_self=True)[:n_seg]
    hit2 = pos2 < cap
    sl2 = order[pos2.clamp(0, cap - 1).long()]
    sl2l = sl2.long()
    p2 = torch.where(hit2, prices[sl2l], NEG)
    t2 = torch.where(hit2, tenants[sl2l], -1)
    s2 = torch.where(hit2, sl2, -1)
    q2 = torch.where(hit2, seqs[sl2l], -1)
    return pk, tk, sk, qk, p2, t2, s2, q2


def _topk_select(W, Q, payloads, k: int):
    """K-pass top-k selection by (price desc, seq asc) over the last
    axis.  Returns k ``(sel_p, sel_q, (sel_payload, ...))`` tuples of
    ``(rows,)`` tensors, rank ascending."""
    outs = []
    for _ in range(k):
        pm = torch.amax(W, dim=-1)
        cand = (W > NEG / 2) & (W >= pm[:, None])
        qm = torch.amin(torch.where(cand, Q, BIGS), dim=-1)
        selrow = cand & (Q == qm[:, None])
        any_live = pm > NEG / 2
        outs.append((torch.where(any_live, pm, NEG),
                     torch.where(any_live, qm, -1),
                     tuple(torch.amax(torch.where(selrow, pl, -1), dim=-1)
                           for pl in payloads)))
        W = torch.where(selrow, NEG, W)
    return outs


def _merge2(A, a2, B, b2, k):
    """Merge two ranked path aggregates ``(P, T, S, Q, L)`` of
    ``(nodes, k)`` lists and their fall-backs ``(p2, t2, s2, q2, l2)``:
    the merged list is the exact top-k of both sides, the merged
    fall-back the best entry of both sides' full books from a tenant
    other than the merged top tenant."""
    Pa, Ta, Sa, Qa, La = A
    Pb, Tb, Sb, Qb, Lb = B
    W = torch.cat([Pa, Pb], dim=-1)            # (nodes, 2k)
    T = torch.cat([Ta, Tb], dim=-1)
    S = torch.cat([Sa, Sb], dim=-1)
    Q = torch.cat([Qa, Qb], dim=-1)
    L = torch.cat([La, Lb], dim=-1)
    sel = _topk_select(W, Q, (T, S, L), k)
    mP = torch.stack([o[0] for o in sel], dim=-1)
    mQ = torch.stack([o[1] for o in sel], dim=-1)
    mT = torch.stack([o[2][0] for o in sel], dim=-1)
    mS = torch.stack([o[2][1] for o in sel], dim=-1)
    mL = torch.stack([o[2][2] for o in sel], dim=-1)
    t0 = mT[:, 0]
    a_top_is = Ta[:, 0] == t0
    cA = tuple(torch.where(a_top_is, x2, x[:, 0])
               for x2, x in zip(a2, (Pa, Ta, Sa, Qa, La)))
    b_top_is = Tb[:, 0] == t0
    cB = tuple(torch.where(b_top_is, x2, x[:, 0])
               for x2, x in zip(b2, (Pb, Tb, Sb, Qb, Lb)))
    a_wins = (cA[0] > cB[0]) | ((cA[0] == cB[0]) & (cA[3] < cB[3]))
    m2 = tuple(torch.where(a_wins, xa, xb) for xa, xb in zip(cA, cB))
    return (mP, mT, mS, mQ, mL), m2


def clear_sorted(order, sorted_gseg, seg_start, prices, tenants, seqs,
                 level_floor, level_off, strides, owner, limit, k: int):
    """Aggregates plus the hierarchical path merge in one call."""
    n_seg = int(seg_start.shape[0]) - 1
    aggs = _prefix_aggregates(order, sorted_gseg, seg_start, prices,
                              tenants, seqs, n_seg, k)
    return clear_sorted_from_aggs(aggs, level_floor, level_off, strides,
                                  owner, limit, k)


def clear_sorted_from_aggs(aggs, level_floor, level_off: Sequence[int],
                           strides: Sequence[int], owner, limit, k: int):
    """Hierarchical path merge over precomputed aggregates — the
    function the CUDA kernel computes.

    path(root) = agg(root); path(d) = merge2(path(d+1) at the parent,
    agg(d)).  A level with no live entry is skipped: merging it is the
    identity.  The leaf stage applies owner exclusion (with the exact
    fall-back when the owner holds every live merged entry), the path
    floor, the slate and the truncation and eviction flags.

    Returns ``(rate, best_level, cand_slots (n_leaves, k+1), truncated,
    evict)``; the slate holds ranked slots with -1 holes."""
    pk, tk, sk, qk, p2, t2, s2, q2 = aggs
    n_lvl = len(strides)
    n_leaves = owner.shape[0]
    dev = owner.device

    def nodes_at(d):
        return -(-n_leaves // strides[d])

    def lvl_slice(arr, d):
        return arr[level_off[d]:level_off[d] + nodes_at(d)]

    def ranked(d):
        P, T, S, Q = (lvl_slice(a, d) for a in (pk, tk, sk, qk))
        return (P, T, S, Q, torch.where(P > NEG / 2, d, -1).to(torch.int32))

    def fallback(d):
        p, t, s, q = (lvl_slice(a, d) for a in (p2, t2, s2, q2))
        return (p, t, s, q, torch.where(p > NEG / 2, d, -1).to(torch.int32))

    top = n_lvl - 1
    path, path2 = ranked(top), fallback(top)
    for d in range(n_lvl - 2, -1, -1):
        nd = nodes_at(d)
        parent = (torch.arange(nd, device=dev) * strides[d]) \
            // strides[d + 1]
        if bool((lvl_slice(pk, d)[:, 0] > NEG / 2).any()):
            A = tuple(x[parent] for x in path)
            a2 = tuple(x[parent] for x in path2)
            path, path2 = _merge2(A, a2, ranked(d), fallback(d), k)
        else:
            path = tuple(x[parent] for x in path)
            path2 = tuple(x[parent] for x in path2)

    # ---- leaf stage: floor combine, owner exclusion, slate ----
    leaf = torch.arange(n_leaves, device=dev)
    il = leaf // strides[0]
    P, T, S, Q, L = (x[il] for x in path)          # (n_leaves, k)
    fp, ft, fs, fq, fl2 = (x[il] for x in path2)
    floor = leaf_floor(level_floor, strides, n_leaves, dev)
    has_owner = owner >= 0
    live_m = P > NEG / 2
    excl = has_owner[:, None] & (T == owner[:, None])
    Pex = torch.where(excl, NEG, P)
    all_owned = has_owner & live_m[:, 0] \
        & torch.all(~live_m | excl, dim=-1)
    E = torch.cat([Pex, torch.where(all_owned, fp, NEG)[:, None]], dim=-1)
    ES = torch.cat([S, fs[:, None]], dim=-1)
    EL = torch.cat([L, fl2[:, None]], dim=-1)
    top_p = torch.amax(E, dim=-1)
    rate = torch.maximum(floor, torch.clamp_min(top_p, 0.0))
    col0 = torch.argmax(i32((E >= top_p[:, None]) & (E > NEG / 2)), dim=-1)
    best_level = torch.where(
        top_p > NEG / 2,
        torch.gather(EL, 1, col0[:, None])[:, 0], -1)
    cand_slots = torch.where(
        (E > NEG / 2) & (E >= (floor - EPSF)[:, None]), ES, -1)
    full = live_m[:, k - 1]
    truncated = i32(full & (P[:, k - 1] >= floor - EPSF))
    evict = i32((owner >= 0) & (rate > limit + EPSF))
    return rate, best_level, cand_slots, truncated, evict
