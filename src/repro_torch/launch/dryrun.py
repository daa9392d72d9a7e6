"""Multi-pod dry run: trace every (architecture x input-shape) cell on the
production meshes and extract its roofline terms, the twin of
``repro.launch.dryrun``.

The reference lowers each cell through XLA's SPMD partitioner on 256 or
512 fake host devices.  Here this process joins a fake process group of
512 ranks as rank 0 (``torch.testing``'s ``fake`` backend: every
collective returns at once), places the step's inputs as ``meta``
DTensors on the production mesh, and runs the step once under a
recorder (``launch.cells.trace_cell``): DTensor's propagation inserts
the collectives, and rank 0's local ops are counted.  Nothing is
allocated.

Per cell this records: per-device FLOPs / bytes, the memory of the
step's local blocks, the collective schedule (op kind x group size x
operand / wire bytes), and the trace's host seconds.  The port runs
every layer unrolled, so the counts are direct (``corrected`` is the
direct count; the reference extrapolates from k = 1 and k = 2
superblock probes, which ``tests/test_torch_dryrun.py`` holds equal to
it).  Results are cached as JSON under experiments/dryrun_torch/.

The fake group is this module's entry point's alone: it runs in its own
process (``main``; ``sweep`` starts one per cell), never in a process
that uses a real group.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep   # everything
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import traceback
from typing import Any, Dict, Iterable, List

ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_OUT = ROOT / "experiments" / "dryrun_torch"
FAKE_RANKS = 512                 # the multi-pod mesh; the single uses 256
HOST_CARDS = 8                   # an H100 host (HGX): 8 cards on NVLink


def _write_rec(out_path: pathlib.Path, rec: Dict[str, Any]) -> None:
    """Atomic cell-record write: a sweep killed mid-dump must not leave
    a truncated json."""
    tmp = out_path.with_name(f".tmp_{out_path.name}")
    with open(tmp, "w") as f:
        f.write(json.dumps(rec, indent=1))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out_path)


def collective_summary(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum operand and wire bytes for every collective call (``kind``,
    ``group``, ``in_bytes``, ``out_bytes``: one device's), keyed
    ``"<kind>@g<group>"``, with the reference's ring estimates: AG
    out*(g-1)/g, RS in*(g-1)/g, AR 2*in*(g-1)/g, A2A in*(g-1)/g, permute
    = in.  A group of one moves nothing and is left out.  The port's
    bf16 collectives are bf16 (the reference's XLA-CPU lowering upcasts
    them to f32), so ``wire_bytes_adj`` equals ``wire_bytes``."""
    per_op: Dict[str, Dict[str, float]] = {}
    for e in events:
        op, g = e["kind"], e["group"]
        if g <= 1:
            continue
        in_bytes, out_bytes = e["in_bytes"], e["out_bytes"]
        ratio = (g - 1) / g
        if op == "all-gather":
            wire = out_bytes * ratio
        elif op == "reduce-scatter":
            wire = in_bytes * ratio
        elif op == "all-reduce":
            wire = 2.0 * in_bytes * ratio
        elif op == "all-to-all":
            wire = in_bytes * ratio
        else:
            wire = in_bytes
        d = per_op.setdefault(f"{op}@g{g}", {"count": 0, "operand_bytes": 0.0,
                                             "wire_bytes": 0.0,
                                             "wire_bytes_adj": 0.0})
        d["count"] += 1
        d["operand_bytes"] += in_bytes
        d["wire_bytes"] += wire
        d["wire_bytes_adj"] += wire
    return {"per_op": per_op,
            "operand_bytes": sum(d["operand_bytes"] for d in per_op.values()),
            "wire_bytes": sum(d["wire_bytes"] for d in per_op.values()),
            "wire_bytes_adj": sum(d["wire_bytes_adj"]
                                  for d in per_op.values()),
            "while_ops": 0}


def _parse_overrides(spec: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for kv in (spec or "").split(","):
        if not kv:
            continue
        k, v = kv.split("=", 1)
        for conv in (int, float):
            try:
                v = conv(v)
                break
            except ValueError:
                pass
        out[k] = v
    return out


def start_fake_group(world_size: int = FAKE_RANKS) -> None:
    """This process as rank 0 of a fake group of ``world_size`` ranks
    (the dry run's own process only).  The meshes are of ``meta``
    devices, and DTensor's cost model, which picks each op's placements,
    asks ``torch.<device type>`` how many devices a host has: ``meta``
    gets a device module saying ``HOST_CARDS`` (through torch's
    ``_register_device_module``, in this process).  A ``cpu`` mesh would
    not do: DTensor swaps each all-to-all for an all-gather there (gloo
    has none)."""
    import types

    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not hasattr(torch, "meta"):
        cards = types.ModuleType("torch.meta")
        cards.device_count = lambda: HOST_CARDS
        torch._register_device_module("meta", cards)
    if dist.is_initialized():
        if dist.get_backend() != "fake" or \
                dist.get_world_size() < world_size:
            raise RuntimeError("the dry run needs its own process: a real "
                               "default group is already up")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: pathlib.Path, force: bool = False,
             overrides: str = "", tag: str = "") -> Dict[str, Any]:
    import dataclasses as _dc
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    from repro_torch.configs import SHAPES, applicable_shapes, get_config
    from repro_torch.launch import analytic
    from repro_torch.launch.cells import build_cell, cost_analysis_dict, \
        trace_cell, uneven_leaves
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    ov = _parse_overrides(overrides)
    if ov:
        cfg = _dc.replace(cfg, **ov)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "overrides": overrides}
    if shape_name not in applicable_shapes(cfg):
        rec["status"] = "skipped"
        rec["reason"] = ("long-context decode requires sub-quadratic "
                         "attention; this arch is pure full-attention "
                         "(see docs/DESIGN.md §Arch-applicability)")
        _write_rec(out_path, rec)
        return rec
    try:
        start_fake_group()
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        n_dev = mesh.size()
        cell = build_cell(cfg, shape, mesh)
        tr = trace_cell(cell)
        ca = cost_analysis_dict(tr)
        colls = collective_summary(tr["collectives"])
        print(f"[{arch} {shape_name} {mesh_kind}] flops/dev:", ca["flops"],
              "bytes/dev:", ca["bytes accessed"], "trace_s:",
              round(tr["trace_s"], 2), flush=True)
        mf = analytic.model_flops(cfg, shape)
        dp = sizes.get("pod", 1) * sizes["data"]
        mem = analytic.analytic_memory(cfg, shape, n_dev, dp, sizes["model"])
        corrected = {"flops_per_dev": ca["flops"],
                     "bytes_per_dev": ca["bytes accessed"],
                     "wire_bytes_per_dev": colls["wire_bytes"],
                     "wire_bytes_adj_per_dev": colls["wire_bytes_adj"],
                     "operand_bytes_per_dev": colls["operand_bytes"]}
        rec.update({
            "status": "ok",
            "step": cell.step_name,
            "n_devices": n_dev,
            "lower_s": None,
            "compile_s": None,
            "trace_s": round(tr["trace_s"], 2),
            "flops_per_dev": ca["flops"],
            "bytes_per_dev": ca["bytes accessed"],
            "cost_analysis": ca,
            "memory_analysis": {
                "argument_bytes": tr["argument_bytes"],
                "output_bytes": tr["output_bytes"],
                "temp_bytes": tr["temp_bytes"],
                "generated_code_bytes": None,
            },
            "collectives": colls,
            "corrected": corrected,
            "model_flops": mf,
            "analytic_memory_per_dev": mem,
            "uneven_leaves": uneven_leaves(cell),
        })
    except Exception as e:  # record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[{arch} {shape_name} {mesh_kind}] FAILED: {e}",
              file=sys.stderr, flush=True)
    _write_rec(out_path, rec)
    return rec


def all_cells() -> List[Dict[str, str]]:
    # import lazily to keep --help fast
    from repro_torch.configs import ARCHS, SHAPES
    cells = []
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                cells.append({"arch": arch, "shape": shape, "mesh": mesh})
    return cells


def sweep(out_dir: pathlib.Path, force: bool, mesh_filter: str) -> int:
    """Run every cell in a fresh subprocess (a cell's crash cannot take
    down the sweep)."""
    failures = 0
    cells = [c for c in all_cells()
             if mesh_filter in ("both", c["mesh"])]
    for i, c in enumerate(cells):
        out_path = out_dir / f"{c['arch']}__{c['shape']}__{c['mesh']}.json"
        if out_path.exists() and not force:
            rec = json.loads(out_path.read_text())
            print(f"[{i+1}/{len(cells)}] cached {c['arch']} {c['shape']} "
                  f"{c['mesh']}: {rec.get('status')}", flush=True)
            continue
        print(f"[{i+1}/{len(cells)}] {c['arch']} {c['shape']} {c['mesh']}",
              flush=True)
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             c["arch"], "--shape", c["shape"], "--mesh", c["mesh"],
             "--out", str(out_dir)] + (["--force"] if force else []),
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True)
        if r.returncode != 0:
            failures += 1
            print(r.stdout[-2000:], r.stderr[-2000:], flush=True)
    print(f"sweep done: {len(cells)} cells, {failures} subprocess failures",
          flush=True)
    return failures


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", default="",
                    help="cfg overrides, e.g. attn_softmax_dtype=bfloat16")
    ap.add_argument("--tag", default="",
                    help="suffix for the output JSON (perf variants)")
    ap.add_argument("--sweep", action="store_true",
                    help="run every cell in subprocesses, with caching")
    args = ap.parse_args()
    out_dir = pathlib.Path(args.out)
    if args.sweep:
        sys.exit(1 if sweep(out_dir, args.force, args.mesh) else 0)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not (args.arch and args.shape):
        ap.error("--arch/--shape required (or --sweep)")
    for mk in meshes:
        rec = run_cell(args.arch, args.shape, mk, out_dir, args.force,
                       overrides=args.override, tag=args.tag)
        status = rec.get("status")
        print(f"{args.arch} {args.shape} {mk}: {status}")
        if status == "error":
            print(rec.get("error"))
            sys.exit(1)


if __name__ == "__main__":
    main()
