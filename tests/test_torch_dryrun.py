"""Parity of the port's dry run (``repro_torch.launch.analytic``,
``cells``, ``dryrun``) with the reference's, and the kernel ops on the
``meta`` device it traces on.

The JAX side runs in one subprocess with four forced host devices
(``conftest.run_with_devices``): importing ``repro.launch.dryrun`` sets
``XLA_FLAGS`` for its process, and a test worker must keep its one
device.  The fake-group side runs in a subprocess of its own
(``launch.dryrun.start_fake_group``): a fake default group must never
reach a test worker, where later tests make real gloo groups.

Tolerances: the analytic terms, the cell tables and the collective
accounting equal the reference's (floats bit for bit through JSON); the
argument bytes equal ``memory_analysis().argument_size_in_bytes``
exactly; rank 0's matrix FLOPs on a (2, 2) mesh are a quarter of the
one-rank count exactly; the superblock probes' extrapolation equals the
direct count exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import analytic, cells, dryrun

MESHES = ((16, 16), (32, 16))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# post-SPMD HLO lines of every collective kind (one as -start/-done), and
# the same calls as the port's recorder writes them
HLO = """
  %ag = bf16[64,128]{1,0} all-gather(bf16[16,128]{1,0} %p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[16,128]{1,0} reduce-scatter(f32[64,128]{1,0} %p1), replica_groups=[4,4]<=[16], dimensions={0}, to_apply=%add
  %ars = f32[32,32]{1,0} all-reduce-start(f32[32,32]{1,0} %p2), replica_groups={{0,1}}, to_apply=%add
  %ard = f32[32,32]{1,0} all-reduce-done(f32[32,32]{1,0} %ars)
  %ar2 = bf16[1024]{0} all-reduce(bf16[1024]{0} %p3), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, to_apply=%add
  %a2a = bf16[8,64]{1,0} all-to-all(bf16[8,64]{1,0} %p4), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %cp = bf16[8,8]{1,0} collective-permute(bf16[8,8]{1,0} %p5), source_target_pairs={{0,1},{1,0}}
  %one = f32[4]{0} all-reduce(f32[4]{0} %p6), replica_groups={{0}}, to_apply=%add
"""
HLO_DEVICES = 16
EVENTS = [
    {"kind": "all-gather", "group": 4, "in_bytes": 16 * 128 * 2,
     "out_bytes": 64 * 128 * 2},
    {"kind": "reduce-scatter", "group": 4, "in_bytes": 64 * 128 * 4,
     "out_bytes": 16 * 128 * 4},
    {"kind": "all-reduce", "group": 2, "in_bytes": 32 * 32 * 4,
     "out_bytes": 32 * 32 * 4},
    {"kind": "all-reduce", "group": 16, "in_bytes": 2048, "out_bytes": 2048},
    {"kind": "all-to-all", "group": 8, "in_bytes": 8 * 64 * 2,
     "out_bytes": 8 * 64 * 2},
    {"kind": "collective-permute", "group": HLO_DEVICES, "in_bytes": 128,
     "out_bytes": 128},
    {"kind": "all-reduce", "group": 1, "in_bytes": 16, "out_bytes": 16},
]

_REF = """
import dataclasses, json, sys
import jax, jax.numpy as jnp
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import analytic
from repro.launch.cells import build_cell, input_specs, lower_cell, \\
    reduced_depth
from repro.launch.dryrun import all_cells, parse_collectives
from repro.launch.mesh import make_mesh
out = {{"analytic": {{}}, "reduced_depth": {{}}, "inputs": {{}}}}
for name, cfg in ARCHS.items():
    out["reduced_depth"][name] = [dataclasses.asdict(reduced_depth(cfg, k))
                                  for k in (1, 2)]
    out["analytic"][name + "/params"] = analytic.effective_params(cfg)
    for sname, shape in SHAPES.items():
        key = name + "/" + sname
        out["inputs"][key] = {{k: [list(v.shape), str(v.dtype)] for k, v in
                              input_specs(cfg, shape).items()}}
        a = {{"attn_flops": analytic.attn_flops(cfg, shape),
              "model_flops": analytic.model_flops(cfg, shape),
              "kv_cache_bytes": analytic.kv_cache_bytes(
                  cfg, shape.global_batch, shape.seq_len)}}
        for dp, tp in {meshes!r}:
            a[f"kernelized_bytes/{{dp}}x{{tp}}"] = analytic.kernelized_bytes(
                cfg, shape, dp, tp)
            a[f"analytic_memory/{{dp}}x{{tp}}"] = analytic.analytic_memory(
                cfg, shape, dp * tp, dp, tp)
        out["analytic"][key] = a
out["all_cells"] = all_cells()
out["collectives"] = parse_collectives({hlo!r}, {n_dev})
cfg = get_config("qwen3-0.6b").reduced()
cell = build_cell(cfg, SHAPES["train_4k"], make_mesh((2, 2),
                                                     ("data", "model")))
ma = lower_cell(cell).compile().memory_analysis()
out["argument_bytes"] = ma.argument_size_in_bytes
print("REF " + json.dumps(out))
"""

_FAKE = """
import json
from repro_torch.launch import dryrun
dryrun.start_fake_group(4)
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_mesh
cfg = get_config("qwen3-0.6b").reduced()
shape = SHAPES["train_4k"]
one = cells.trace_cell(cells.build_cell(cfg, shape, make_mesh(
    (1, 1), ("data", "model"), "meta")))
cell = cells.build_cell(cfg, shape, make_mesh((2, 2), ("data", "model"),
                                              "meta"))
four = cells.trace_cell(cell)
mesh = make_mesh((2, 2), ("data", "model"), "meta")
probes = {{}}
for arch, layers in (("qwen3-0.6b", 4), ("olmoe-1b-7b", 3)):
    deep = get_config(arch).reduced(num_layers=layers)
    probes[arch] = [deep.plan_blocks()[2]] + [
        [tr["flops"], tr["bytes accessed"]] for tr in (
            cells.trace_cell(cells.build_cell(c, shape, mesh)) for c in (
                deep, cells.reduced_depth(deep, 1),
                cells.reduced_depth(deep, 2)))]
print("FAKE " + json.dumps({{
    "argument_bytes": four["argument_bytes"], "uneven": cells.uneven_leaves(
        cell), "flops_1x1": one["flops"], "flops_2x2": four["flops"],
    "products_1x1": one["products"], "products_2x2": four["products"],
    "probes": probes}}))
"""


def _json_line(r, tag):
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(s for s in r.stdout.splitlines() if s.startswith(tag + " "))
    return json.loads(line[len(tag) + 1:])


@pytest.fixture(scope="module")
def ref():
    from conftest import run_with_devices
    return _json_line(run_with_devices(_REF.format(
        meshes=MESHES, hlo=HLO, n_dev=HLO_DEVICES), 4, timeout=300), "REF")


@pytest.fixture(scope="module")
def fake():
    r = subprocess.run([sys.executable, "-c", _FAKE.format()],
                       env={**os.environ,
                            "PYTHONPATH": os.path.join(ROOT, "src")},
                       capture_output=True, text=True, timeout=300)
    return _json_line(r, "FAKE")


def _canon(x):
    """JSON's view of a value (tuples as lists, float keys as str)."""
    return json.loads(json.dumps(x))


def test_analytic_matches_reference(ref):
    """Every ``analytic`` function of the port equals the reference's for
    all ten archs x four shapes and (dp, tp) (16, 16) and (32, 16); only
    the hardware constants differ, and ``fits_v5e`` is ``fits_h100``
    (the same total against the card's capacity)."""
    assert (analytic.PEAK_FLOPS, analytic.HBM_BW, analytic.ICI_BW) == \
        (989e12, 3.35e12, 450e9)
    got = {}
    for name, cfg in ARCHS.items():
        got[name + "/params"] = analytic.effective_params(cfg)
        for sname, shape in SHAPES.items():
            a = {"attn_flops": analytic.attn_flops(cfg, shape),
                 "model_flops": analytic.model_flops(cfg, shape),
                 "kv_cache_bytes": analytic.kv_cache_bytes(
                     cfg, shape.global_batch, shape.seq_len)}
            for dp, tp in MESHES:
                a[f"kernelized_bytes/{dp}x{tp}"] = analytic.kernelized_bytes(
                    cfg, shape, dp, tp)
                mem = analytic.analytic_memory(cfg, shape, dp * tp, dp, tp)
                assert mem.pop("fits_h100") == \
                    (mem["total"] < analytic.HBM_BYTES)
                a[f"analytic_memory/{dp}x{tp}"] = mem
            got[f"{name}/{sname}"] = a
    want = ref["analytic"]
    for key, a in want.items():
        for k, v in a.items():
            if k.startswith("analytic_memory"):
                v.pop("fits_v5e")
    assert _canon(got) == want


def test_cell_tables_match_reference(ref):
    """``reduced_depth`` (k = 1, 2; every config field the port has: it
    leaves out ``ssd_compute_dtype``), ``input_specs``' shapes and dtypes
    for every arch and shape, and ``all_cells`` equal the reference's."""
    for name, cfg in ARCHS.items():
        got = _canon([dataclasses.asdict(cells.reduced_depth(cfg, k))
                      for k in (1, 2)])
        for g, w in zip(got, ref["reduced_depth"][name]):
            assert set(w) - set(g) == {"ssd_compute_dtype"}   # not ported
            assert g == {k: w[k] for k in g}, name
        for sname, shape in SHAPES.items():
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                   for k, v in cells.input_specs(cfg, shape).items()}
            assert all(v.device.type == "meta" for v in
                       cells.input_specs(cfg, shape).values())
            assert got == ref["inputs"][f"{name}/{sname}"], (name, sname)
    assert dryrun.all_cells() == ref["all_cells"]


def test_collective_accounting_matches_reference(ref):
    """``collective_summary`` of the calls equals the reference's
    ``parse_collectives`` of the same collectives as post-SPMD HLO lines:
    all-gather, reduce-scatter, all-reduce (one as -start / -done),
    all-to-all and collective-permute, a group of one left out."""
    assert _canon(dryrun.collective_summary(EVENTS)) == ref["collectives"]


def test_argument_bytes_match_reference(ref, fake):
    """A reduced qwen3 train cell's per-device argument bytes on a (2, 2)
    fake mesh (the local blocks of the state and the batch) equal the
    reference's ``memory_analysis().argument_size_in_bytes`` on a (2, 2)
    mesh; every leaf divides evenly there."""
    assert fake["uneven"] == []
    assert fake["argument_bytes"] == ref["argument_bytes"]


def test_matrix_flops_split_over_mesh(fake):
    """Rank 0's matrix FLOPs of a reduced qwen3 train step on a (2, 2)
    mesh (batch over "data", heads, MLP and vocab over "model") are a
    quarter of the one-rank count: no product is left whole on every
    rank."""
    assert fake["flops_2x2"] > 0
    assert 4 * fake["flops_2x2"] == fake["flops_1x1"], (
        sorted(map(tuple, fake["products_2x2"])),
        sorted(map(tuple, fake["products_1x1"])))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b"])
def test_probe_extrapolation_matches_direct_count(fake, arch):
    """The reference's count from its k = 1 and k = 2 superblock probes,
    ``c1 + (n - 1) (c2 - c1)``, equals the port's direct count of every
    layer, FLOPs and bytes, on a reduced train cell of n > 2
    superblocks on a (2, 2) mesh (qwen3: 4 layers; olmoe: 3, the
    ``moe_ep`` path)."""
    n, direct, k1, k2 = fake["probes"][arch]
    assert n > 2
    assert [a + (n - 1) * (b - a) for a, b in zip(k1, k2)] == direct


def _kernel_cases():
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.moe_route import ops as rops
    from repro_torch.kernels.moe_route import ref as rref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    q = lambda s, dt=torch.float32: torch.randn(s, dtype=dt)  # noqa: E731
    B, S, K, G, hd = 2, 64, 2, 2, 16
    yield ("decode_attention",
           lambda *a: dops.decode_attention(*a, 40, 16),
           lambda *a: dref.decode_attention_ref(*a, 40, 16),
           (q((B, K, G, hd), torch.bfloat16), q((B, S, K, hd),
                                                torch.bfloat16),
            q((B, S, K, hd), torch.bfloat16)))
    yield ("moe_route", lambda lg: rops.route_dense(lg, 2, True,
                                                    torch.bfloat16),
           lambda lg: rref.route_dense_ref(lg, 2, True, torch.bfloat16),
           (q((32, 8)),))
    H, P, N = 4, 8, 16
    yield ("ssd_scan", lambda *a: sops.ssd_scan(*a, 16),
           lambda *a: sref.ssd_scan_ref(*a, 16),
           (q((B, S, H, P)), q((B, S, H)).abs(), -q((H,)).abs(),
            q((B, S, N)), q((B, S, N))))


@pytest.mark.parametrize("case", list(_kernel_cases()),
                         ids=lambda c: c[0])
def test_kernel_ops_on_meta(case):
    """Each kernel op on ``meta`` tensors gives its plain version's
    shapes and dtypes (the plain version, traced with no storage), and
    still raises on a device it has no path for."""
    _, op, plain, args = case
    want = plain(*args)
    got = op(*(a.to("meta") for a in args))
    want, got = (tuple(t) if isinstance(t, tuple) else (t,)
                 for t in (want, got))
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)
    with pytest.raises(ValueError, match="no .* for device xpu"):
        op(*map(OtherDevice, args))


class OtherDevice(torch.Tensor):
    """A tensor with no storage that reports the ``xpu`` device (a device
    type with no path in the ops, and none a CPU-only torch can make),
    for the ops' device check."""

    @staticmethod
    def __new__(cls, like):
        return torch.Tensor._make_wrapper_subclass(
            cls, like.shape, dtype=like.dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} reached a tensor of no device")
