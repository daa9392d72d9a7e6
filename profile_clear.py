#!/usr/bin/env python3
"""The market-clearing kernel alone, on the 10k fleet's final book.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 profile_clear.py                  # this checkout's kernel
    python3 profile_clear.py --compare DIR    # DIR, here, here, DIR

The clearing pass's inputs are the ``_prefix_aggregates`` of the book
that ``chip_smoke.py``'s fleet main path (``FLEET_10K``: 10,000 leaves,
k=16, 21 epochs) ends with, and its owners, limits and floors.  The first
run makes them and saves them to ``chiprun_out/clear_book.pt``; later
runs load that file, so every run times the same inputs.

One run imports ``repro_torch`` from ``--root`` (default: this
checkout), holds the kernel to its plain version (``torch.equal`` on all
five outputs) and prints one JSON line: the kernel's device time per
call (CUDA events over calls captured in one CUDA graph), its eager time
(back-to-back calls, host enqueue included), its host enqueue time
(the host clock over the calls, before synchronising), the plain
version's eager
time (it reads the device, so it cannot be captured) and the bound of
``chip_smoke._clear_bound``.  ``--compare DIR`` runs that in four child
processes, DIR, this checkout, this checkout, DIR, on one card, so two
versions of the kernel (DIR unpacked from another commit with
``git archive``) are compared in turns.  Lines go to
``chiprun_out/profile_clear.jsonl``.  Needs CUDA; it never runs on the
CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "chiprun_out"
BOOK = OUT / "clear_book.pt"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _make_book(dev):
    """Run the fleet main path and keep its last clearing inputs."""
    import torch
    from repro_torch.kernels.market_clear import ref as R
    from repro_torch.market_torch.engine import build_tree
    from repro_torch.sim.simulator import FLEET_10K, FleetScenarioConfig, \
        run_fleet_scenario
    res = run_fleet_scenario(FleetScenarioConfig(**FLEET_10K), device=dev)
    est = res.engine_state
    tree = build_tree(FLEET_10K["n_leaves"])
    k = FLEET_10K["k"]
    n_seg = est["seg_start"].shape[0] - 1
    aggs = R._prefix_aggregates(est["order"], est["sorted_gseg"],
                                est["seg_start"], est["price"],
                                est["tenant"], est["seq"], n_seg, k)
    level_off, acc = [], 0
    for d in range(tree.n_levels):
        level_off.append(acc)
        acc += tree.nodes_at(d)
    book = {"aggs": [a.cpu() for a in aggs],
            "floor": [f.cpu() for f in est["floor"]],
            "level_off": level_off, "strides": list(tree.strides),
            "owner": est["owner"].cpu(), "limit": est["limit"].cpu(),
            "k": k, "orders": res.stats["orders"],
            "transfers": res.stats["transfers"]}
    torch.cuda.synchronize()
    return book


def _host_ms(fn, reps):
    """Host time per call of ``fn(i)`` over ``reps`` calls, read before
    synchronising: the wrapper's enqueue time."""
    import time
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def run_one(root: pathlib.Path, book_path: pathlib.Path) -> dict:
    import torch
    sys.path.insert(0, str(root / "src"))
    from chip_smoke import _clear_bound, _graph_ms, _time_ms
    from repro_torch.kernels.market_clear import kernel as K
    from repro_torch.kernels.market_clear import ref as R
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if book_path.exists():
        book = torch.load(book_path)
    else:
        book = _make_book(dev)
        book_path.parent.mkdir(exist_ok=True)
        torch.save(book, book_path)
    aggs = tuple(a.to(dev) for a in book["aggs"])
    k = book["k"]
    args = (tuple(f.to(dev) for f in book["floor"]),
            tuple(book["level_off"]), tuple(book["strides"]),
            book["owner"].to(dev), book["limit"].to(dev))
    got = K.clear_cuda(*aggs, *args)
    plain = R.clear_sorted_from_aggs(aggs, *args, k)
    torch.cuda.synchronize()
    equal = all(bool(torch.equal(a, b)) for a, b in zip(plain, got))
    if not equal:
        raise SystemExit(f"market_clear from {root} differs from its plain "
                         "version on the final book")
    n_leaves = args[3].shape[0]
    bound_ms, bound_by, nbytes, ops = _clear_bound(aggs, n_leaves, k,
                                                   args[2])
    return {"root": str(root), "card": _card(),
            "kernel_source_bytes": (root / "src" / "repro_torch" / "csrc"
                                    / "market_clear.cu").stat().st_size,
            "equal": equal, "n_seg": int(aggs[0].shape[0]), "k": k,
            "n_leaves": int(n_leaves),
            "ms": _graph_ms(lambda i: K.clear_cuda(*aggs, *args), 200),
            "ms_eager": _time_ms(lambda i: K.clear_cuda(*aggs, *args), 200),
            "host_ms": _host_ms(lambda i: K.clear_cuda(*aggs, *args), 200),
            "plain_ms_eager": _time_ms(
                lambda i: R.clear_sorted_from_aggs(aggs, *args, k), 20),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "operations": ops, "book_orders": book["orders"],
            "book_transfers": book["transfers"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose repro_torch is timed")
    ap.add_argument("--compare", type=pathlib.Path, default=None,
                    help="another checkout: run it, here, here, it")
    ap.add_argument("--book", type=pathlib.Path, default=BOOK)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_clear needs a CUDA device")
    if a.compare is None:
        rows = [run_one(a.root.resolve(), a.book)]
    else:
        rows = []
        for root in (a.compare, HERE, HERE, a.compare):
            res = subprocess.run(
                [sys.executable, str(HERE / "profile_clear.py"), "--root",
                 str(root.resolve()), "--book", str(a.book)],
                capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise SystemExit(f"profile_clear failed for {root}:\n"
                                 f"{res.stderr[-4000:]}")
            rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
    lines = [json.dumps(r) for r in rows]
    for line in lines:
        print(line, flush=True)
    if a.compare is None:             # a comparison's runs wrote theirs
        OUT.mkdir(exist_ok=True)
        with open(OUT / "profile_clear.jsonl", "a") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
