#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (one JSON line each):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA source under ``src/repro_torch/csrc``;
2. every kernel against its plain PyTorch version on the same CUDA
   tensors (all outputs ``torch.equal``), and the whole fleet slice at a
   small size on the card against the same run on the CPU (identical
   state, perf and stats);
3. the main path: ``run_fleet_scenario`` on ``FLEET_10K`` (10,000 leaves,
   1,000 tenants, 21 epochs) on the card, with every launch count set to 0
   just before and read just after; the counts must be nonzero and the
   clearing kernel must run once per cascade wave; orders and transfers
   are held to the committed ``BENCH_fig06.json`` row;
4. a ``kernels`` line: per kernel, its launches on the main path, its
   time per call (CUDA events), the plain version's time on the same
   inputs, and the least time the card could take (bytes over 3.35 TB/s
   or operations over 67 TFLOP/s, whichever is larger).

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
nonzero before it; without CUDA, or without the repository beside it,
the script exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "chiprun_out"

# the committed reference row fig06/scale/fused_epoch/backend=jnp/n=10000
# (BENCH_fig06.json): deterministic counts the port must reproduce
COMMITTED_10K = {"orders": 52310, "transfers": 14123, "epochs": 21}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM, float32 outside tensor cores

_LINES = []


def emit(obj) -> None:
    line = json.dumps(obj)
    _LINES.append(line)
    print(line, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ------------------------------------------------------------------ phase 1
def phase_card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from repro_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    for name in names:
        build.build(name)         # raises on a failed build
    emit({"phase": "build", "card": card, "kernels": names,
          "build_s": {n: round(build.BUILD_SECONDS.get(n, 0.0), 3)
                      for n in names},
          "wall_s": round(time.perf_counter() - t0, 3)})
    return card


# ------------------------------------------------------------------ phase 2
def _book(tree, k, seed, n_bids, n_ten, dev, root_frac=0.0, cap=4096):
    """A random sorted book and ownership on ``dev`` (numpy-seeded)."""
    import numpy as np
    import torch
    from repro_torch.market_torch.engine import BatchEngine
    rng = np.random.default_rng(seed)
    eng = BatchEngine(tree, capacity=cap, k=k, device=dev)
    st = eng.init_state()
    st["floor"][-1] = torch.tensor([1.5], dtype=torch.float32, device=dev)
    levels = rng.integers(0, tree.n_levels, n_bids).astype(np.int32)
    levels[rng.random(n_bids) < root_frac] = tree.n_levels - 1
    nodes = np.array([rng.integers(0, tree.nodes_at(d)) for d in levels],
                     np.int32)
    prices = rng.uniform(1, 9, n_bids).astype(np.float32)
    prices[::3] = np.round(prices[::3])          # equal-price ties
    tenants = rng.integers(0, n_ten, n_bids).astype(np.int32)
    st = eng.place(st, *(torch.from_numpy(a).to(dev)
                         for a in (prices, levels, nodes, tenants)))
    owned = rng.random(tree.n_leaves) < 0.8
    st["owner"] = torch.from_numpy(np.where(
        owned, rng.integers(0, n_ten, tree.n_leaves), -1)
        .astype(np.int32)).to(dev)
    st["limit"] = torch.from_numpy(np.where(
        owned, rng.uniform(2, 8, tree.n_leaves), np.inf)
        .astype(np.float32)).to(dev)
    return eng, st


def _lap_book(dev):
    import torch
    from repro_torch.market_torch.engine import BatchEngine, build_tree
    tree = build_tree(64)
    eng = BatchEngine(tree, capacity=8, k=4, device=dev)
    st = eng.init_state()
    root = tree.n_levels - 1

    def bids(tenants):
        m = len(tenants)
        return (torch.full((m,), 5.0, device=dev),
                torch.full((m,), root, dtype=torch.int32, device=dev),
                torch.zeros((m,), dtype=torch.int32, device=dev),
                torch.tensor(tenants, dtype=torch.int32, device=dev))
    st = eng.place(st, *bids(list(range(8))))
    for slot, ten in ((5, 8), (2, 9)):   # reused slots invert seq order
        st = eng.cancel(st, torch.tensor([slot], dtype=torch.int32,
                                         device=dev))
        st = eng.place(st, *bids([ten]))
    return eng, st


def _truncated_book(dev):
    import numpy as np
    import torch
    from repro_torch.market_torch.engine import BatchEngine, build_tree
    tree = build_tree(512)
    eng = BatchEngine(tree, capacity=4096, k=2, device=dev)
    st = eng.init_state()
    rng = np.random.default_rng(5)
    m = 40
    st = eng.place(st, torch.from_numpy(
        rng.uniform(3, 9, m).astype(np.float32)).to(dev),
        torch.ones(m, dtype=torch.int32, device=dev),
        torch.zeros(m, dtype=torch.int32, device=dev),
        torch.arange(m, dtype=torch.int32, device=dev))
    return eng, st


def _clear_inputs(eng, st):
    from repro_torch.kernels.market_clear import ref as R
    n_seg = st["seg_start"].shape[0] - 1
    aggs = R._prefix_aggregates(st["order"], st["sorted_gseg"],
                                st["seg_start"], st["price"], st["tenant"],
                                st["seq"], n_seg, eng.k)
    return aggs, tuple(st["floor"])


def _run_both(eng, st, health=None):
    """Kernel and plain version on the same CUDA tensors."""
    import torch
    from repro_torch.kernels.market_clear import kernel as K
    from repro_torch.kernels.market_clear import ref as R
    aggs, floors = _clear_inputs(eng, st)
    args = (floors, eng.level_off, eng.tree.strides, st["owner"],
            st["limit"])
    plain = R.clear_sorted_from_aggs(aggs, *args, eng.k)
    got = K.clear_cuda(*aggs, *args)
    torch.cuda.synchronize()
    if health is not None:
        mask = (floors, eng.tree.strides, st["owner"], st["limit"])
        plain = R.apply_health_mask(health, *plain, *mask)
        got = R.apply_health_mask(health, *got, *mask)
    return plain, got


def phase_kernel_vs_plain(dev):
    import numpy as np
    import torch
    from repro_torch.market_torch.engine import TreeSpec, build_tree
    names = ("rate", "best_level", "cand_slots", "truncated", "evict")
    cases = []
    for k in (1, 8, 16):
        cases.append((f"n10000_k{k}", *_book(
            build_tree(10000), k, 100 + k, 8192, 1000, dev,
            root_frac=0.5, cap=16384), None))
    cases.append(("n24_nonpow2_k4", *_book(
        TreeSpec(24, (1, 4, 12, 24)), 4, 7, 120, 9, dev), None))
    cases.append(("lap_reused_seq_ties", *_lap_book(dev), None))
    cases.append(("truncated_slates", *_truncated_book(dev), None))
    eng, st = _book(build_tree(768), 8, 9, 700, 9, dev)
    health = torch.from_numpy(np.random.default_rng(10).choice(
        [0, 0, 1, 2], 768).astype(np.int32)).to(dev)
    cases.append(("health_masked", eng, st, health))
    for name, eng, st, health in cases:
        plain, got = _run_both(eng, st, health)
        equal = {n: bool(torch.equal(a, b))
                 for n, a, b in zip(names, plain, got)}
        err = float((plain[0] - got[0]).abs().max())
        emit({"phase": "kernel_vs_plain", "kernel": "market_clear",
              "case": name, "k": eng.k, "n_leaves": eng.tree.n_leaves,
              "equal": equal, "max_abs_err": err, "tolerance": 0.0})
        if not all(equal.values()):
            fail(f"market_clear kernel differs from its plain version "
                 f"on {name}: {equal}")


def phase_small_slice(dev):
    """The whole slice on the card against the same run on the CPU
    (plain versions), at the size of the repository's epoch tests."""
    import numpy as np
    import torch
    from repro_torch.convert import to_numpy
    from repro_torch.sim.simulator import FleetScenarioConfig, \
        run_fleet_scenario
    cfg = FleetScenarioConfig(
        regime="heavy", n_leaves=256, n_training=6, n_inference=6,
        n_batch=4, duration_s=900.0, tick_s=60.0, seed=3, k=8, b_max=128,
        per_tenant_bids=4, alone="analytic")
    gpu = run_fleet_scenario(cfg, device=dev)
    cpu = run_fleet_scenario(cfg, device="cpu")
    eg, ec = to_numpy(gpu.engine_state), to_numpy(cpu.engine_state)

    def same_arrays(a, b):
        if isinstance(a, tuple):
            return all(same_arrays(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b, equal_nan=True)
    diff = [k for k in ec if not same_arrays(ec[k], eg[k])]
    same = (not diff and np.array_equal(gpu.perf, cpu.perf)
            and np.array_equal(gpu.retention, cpu.retention)
            and gpu.stats == cpu.stats)
    emit({"phase": "small_slice_gpu_vs_cpu", "n_leaves": 256,
          "tenants": cfg.n_tenants, "identical": bool(same),
          "differing_keys": diff, "stats": gpu.stats,
          "waves": int(eg["waves"]),
          "mean_retention": gpu.mean_retention})
    if not same:
        fail(f"small fleet slice on the card differs from the CPU run: "
             f"keys {diff}, stats {gpu.stats} vs {cpu.stats}")
    torch.cuda.synchronize()


# ------------------------------------------------------------------ phase 3
def phase_main_path(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.market_clear import kernel as K
    from repro_torch.sim.simulator import FLEET_10K, FleetScenarioConfig, \
        run_fleet_scenario
    cfg = FleetScenarioConfig(**FLEET_10K)
    K.LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_fleet_scenario(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"market_clear": K.LAUNCHES}
    est = res.engine_state
    waves, resorts = int(est["waves"]), int(est["resorts"])
    perf = res.perf
    finite = bool(np.isfinite(perf).all()
                  and torch.isfinite(est["rate"]).all()
                  and torch.isfinite(est["bills"]).all())
    ep = np.asarray(res.epoch_s[1:]) * 1e3
    orders, transfers = res.stats["orders"], res.stats["transfers"]
    matches = (orders == COMMITTED_10K["orders"]
               and transfers == COMMITTED_10K["transfers"]
               and len(res.epoch_s) == COMMITTED_10K["epochs"])
    emit({"phase": "main_path", "config": FLEET_10K,
          "epochs": len(res.epoch_s), "orders": orders,
          "transfers": transfers, "committed": COMMITTED_10K,
          "matches_committed": bool(matches), "waves": waves,
          "resorts": resorts, "launches": launches,
          "stats": res.stats,
          "mean_perf": float(np.mean(perf[np.isfinite(perf)])),
          "epoch_ms_p50": float(np.percentile(ep, 50)),
          "epoch_ms_p95": float(np.percentile(ep, 95)),
          "epoch_ms_first": float(res.epoch_s[0] * 1e3),
          "epoch_ms_all": [float(x * 1e3) for x in res.epoch_s],
          "wall_s": wall, "finite": finite})
    if not finite:
        fail("main path produced non-finite perf, rates or bills")
    if waves <= 0 or launches["market_clear"] != waves:
        fail(f"market_clear launched {launches['market_clear']} times on "
             f"the main path for {waves} cascade waves")
    if not matches:
        fail(f"10k run gave orders={orders} transfers={transfers} over "
             f"{len(res.epoch_s)} epochs; committed {COMMITTED_10K}")
    return res, launches


# ------------------------------------------------------------------ phase 4
def _time_ms(fn, reps):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _clear_bound(aggs, n_leaves, k, strides):
    """Least time for one clearing pass on these inputs: each input read
    once and each output written once over the memory rate, or the
    comparisons this data needs (one 2k-wide k-pass selection of ~3
    compares per entry for each populated level under the root, plus
    the leaf stage) over the float32 rate — whichever is larger."""
    pk, tk, sk, qk, p2, t2, s2, q2 = aggs
    n_seg = pk.shape[0]
    in_bytes = 4 * (4 * n_seg * k + 4 * n_seg + n_seg + 2 * n_leaves)
    out_bytes = 4 * (4 * n_leaves + n_leaves * (k + 1))
    nbytes = in_bytes + out_bytes
    off, live_levels = 0, 0
    for d, s in enumerate(strides):
        nodes = -(-n_leaves // s)
        if d < len(strides) - 1 and bool(
                (pk[off:off + nodes, 0] > -5e29).any()):
            live_levels += 1
        off += nodes
    ops = n_leaves * (live_levels * k * 3 * 2 * k + 8 * (k + 1))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def phase_kernels_line(res, launches):
    import torch
    from repro_torch.kernels.market_clear import kernel as K
    from repro_torch.kernels.market_clear import ref as R
    from repro_torch.market_torch.engine import build_tree
    from repro_torch.sim.simulator import FLEET_10K
    est = res.engine_state
    tree = build_tree(FLEET_10K["n_leaves"])
    k = FLEET_10K["k"]
    n_seg = est["seg_start"].shape[0] - 1
    # the main path's last clearing inputs: its final book and owners
    aggs = R._prefix_aggregates(est["order"], est["sorted_gseg"],
                                est["seg_start"], est["price"],
                                est["tenant"], est["seq"], n_seg, k)
    level_off, acc = [], 0
    for d in range(tree.n_levels):
        level_off.append(acc)
        acc += tree.nodes_at(d)
    args = (tuple(est["floor"]), tuple(level_off), tree.strides,
            est["owner"], est["limit"])
    got = K.clear_cuda(*aggs, *args)
    plain = R.clear_sorted_from_aggs(aggs, *args, k)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(plain, got)):
        fail("market_clear differs from its plain version on the main "
             "path's final book")
    err = float((plain[0] - got[0]).abs().max())
    ms = _time_ms(lambda: K.clear_cuda(*aggs, *args), 200)
    plain_ms = _time_ms(lambda: R.clear_sorted_from_aggs(aggs, *args, k),
                        20)
    bound_ms, bound_by, nbytes, ops = _clear_bound(aggs, tree.n_leaves, k,
                                                   tree.strides)
    kern = {"name": "market_clear", "route": "cuda",
            "source": "src/repro_torch/csrc/market_clear.cu",
            "replaces": "src/repro/kernels/market_clear/kernel.py:281",
            "launches": launches["market_clear"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shapes": {"n_seg": int(n_seg), "k": k,
                       "n_leaves": tree.n_leaves},
            "bytes": nbytes, "operations": ops}
    emit({"kernels": [kern]})


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA GPU")
    if not (HERE / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"src/repro_torch not found beside {__file__}: run from a "
             "checkout of the repository")
    sys.path.insert(0, str(HERE / "src"))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    card = phase_card_and_build()
    phase_kernel_vs_plain(dev)
    phase_small_slice(dev)
    res, launches = phase_main_path(dev)
    phase_kernels_line(res, launches)
    emit({"phase": "done", "card": card,
          "total_s": round(time.perf_counter() - t0, 3)})
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.jsonl").write_text("\n".join(_LINES) + "\n")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
