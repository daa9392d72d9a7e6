"""The port's CUDA side: the market-clearing kernel against its plain
version on the card, the whole fleet slice on the card against the CPU
run, and the wrapper and build checks that hold without a card.

No JAX here, so the file also runs on a machine that has only PyTorch
(``pytest -m cuda tests/test_torch_cuda.py`` on the card).  Tests that
need the card carry the ``cuda`` marker and skip without CUDA.
"""
import shutil
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.convert import to_numpy
from repro_torch.kernels import build
from repro_torch.kernels.market_clear import kernel as K
from repro_torch.kernels.market_clear import ops
from repro_torch.kernels.market_clear import ref as R
from repro_torch.market_torch.engine import BatchEngine, TreeSpec, \
    build_tree

NAMES = ("rate", "best_level", "cand_slots", "truncated", "evict")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")


def _book(tree, k, seed, dev, n_bids=700, n_ten=9):
    rng = np.random.default_rng(seed)
    eng = BatchEngine(tree, capacity=4096, k=k, device=dev)
    st = eng.init_state()
    st["floor"][-1] = torch.tensor([1.5], device=dev)
    levels = rng.integers(0, tree.n_levels, n_bids).astype(np.int32)
    nodes = np.array([rng.integers(0, tree.nodes_at(d)) for d in levels],
                     np.int32)
    prices = rng.uniform(1, 9, n_bids).astype(np.float32)
    prices[::3] = np.round(prices[::3])
    tenants = rng.integers(0, n_ten, n_bids).astype(np.int32)
    st = eng.place(st, *(torch.from_numpy(a).to(dev)
                         for a in (prices, levels, nodes, tenants)))
    owned = rng.random(tree.n_leaves) < 0.7
    st["owner"] = torch.from_numpy(np.where(
        owned, rng.integers(0, n_ten, tree.n_leaves), -1)
        .astype(np.int32)).to(dev)
    st["limit"] = torch.from_numpy(np.where(
        owned, rng.uniform(2, 8, tree.n_leaves), np.inf)
        .astype(np.float32)).to(dev)
    return eng, st


def _aggs(eng, st):
    n_seg = st["seg_start"].shape[0] - 1
    return R._prefix_aggregates(st["order"], st["sorted_gseg"],
                                st["seg_start"], st["price"], st["tenant"],
                                st["seq"], n_seg, eng.k)


def test_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never runs the plain version: CPU tensors are
    an error, not a fallback."""
    eng, st = _book(build_tree(64), 4, 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        K.clear_cuda(*_aggs(eng, st), tuple(st["floor"]), eng.level_off,
                     eng.tree.strides, st["owner"], st["limit"])


def test_ops_rejects_other_devices():
    eng, st = _book(build_tree(64), 4, 0, "cpu")
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else
                [f.to("meta") for f in v]) for k, v in st.items()}
    with pytest.raises(ValueError, match="device"):
        ops.clear(meta["order"], meta["sorted_gseg"], meta["seg_start"],
                  meta["price"], meta["tenant"], meta["seq"],
                  tuple(meta["floor"]), eng.level_off, eng.tree.strides,
                  meta["owner"], meta["limit"], eng.k)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc means an error naming it, never a silent plain path."""
    if shutil.which("nvcc") or pathlib.Path(
            "/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build("market_clear")


def test_library_name_follows_source_hash():
    path = build.library_path("market_clear")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("market_clear-") and path.suffix == ".so"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [("n1024", 1), ("n1024", 8),
                                     ("n10000", 16), ("n24", 4)])
def test_kernel_matches_plain_on_card(shape, k):
    _need_cuda()
    tree = TreeSpec(24, (1, 4, 12, 24)) if shape == "n24" \
        else build_tree(int(shape[1:]))
    eng, st = _book(tree, k, 41 + k, "cuda",
                    n_bids=8192 if shape == "n10000" else 700)
    aggs = _aggs(eng, st)
    args = (tuple(st["floor"]), eng.level_off, eng.tree.strides,
            st["owner"], st["limit"])
    before = K.LAUNCHES
    got = K.clear_cuda(*aggs, *args)
    plain = R.clear_sorted_from_aggs(aggs, *args, k)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    for name, a, b in zip(NAMES, plain, got):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_fleet_slice_on_card_matches_cpu():
    """The whole slice at a small size: identical on the card (kernel)
    and on the CPU (plain version), and the kernel ran once per wave."""
    _need_cuda()
    from repro_torch.sim.simulator import FleetScenarioConfig, \
        run_fleet_scenario
    cfg = FleetScenarioConfig(
        regime="heavy", n_leaves=256, n_training=6, n_inference=6,
        n_batch=4, duration_s=600.0, tick_s=60.0, seed=3, k=8, b_max=128,
        per_tenant_bids=4, alone="analytic")
    K.LAUNCHES = 0
    gpu = run_fleet_scenario(cfg, device="cuda")
    assert K.LAUNCHES == int(gpu.engine_state["waves"]) > 0
    cpu = run_fleet_scenario(cfg, device="cpu")
    eg, ec = to_numpy(gpu.engine_state), to_numpy(cpu.engine_state)
    for key in ec:
        pairs = zip(ec[key], eg[key]) if key in ("floor", "floor_t") \
            else [(ec[key], eg[key])]
        for a, b in pairs:
            np.testing.assert_array_equal(a, b, err_msg=key)
    np.testing.assert_array_equal(gpu.perf, cpu.perf)
    assert gpu.stats == cpu.stats
