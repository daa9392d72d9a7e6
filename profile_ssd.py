#!/usr/bin/env python3
"""The SSD scan's backward kernel alone at mamba2-train's shape, in turns
with another checkout.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 profile_ssd.py                    # this checkout's backward
    python3 profile_ssd.py --groups 1 2 3 6   # and at these head groups
    python3 profile_ssd.py --compare DIR      # DIR, here, here, DIR

One run imports ``repro_torch`` from ``--root`` (default: this
checkout) and times ``kernel.ssd_scan_backward_cuda`` at (B 4, S 4,096,
H 48, P 64, N 128, Q 256, bfloat16, no final-state gradient: one SSD
layer of ``chip_smoke.py``'s ``train_mamba2``, on
``_ssd_backward_numbers``' inputs): the graph and eager ms of a call,
its peak memory above the inputs, whether two calls give the same bits,
and, from ``torch.profiler`` over 5 eager calls, each pass's device ms
a call by kernel name (``ssd_chunk_state_kernel`` runs twice a call:
pass 1 and pass 1').  With ``--groups`` (a checkout whose wrapper takes
``groups=``) it adds the graph ms at each head-group count.  Beside
them, the products the checkout's loops issue
(``chip_smoke._ssd_backward_issued``, for the design the checkout's
source holds) and the card's name and power limit.  ``--compare DIR``
runs DIR, this checkout, this checkout, DIR in four child processes on
one card, so two versions (DIR unpacked from another commit with ``git
archive``) are compared in turns.  Lines go to
``chiprun_out/profile_ssd.jsonl``.  Needs CUDA; it never runs on the CPU.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import re
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "chiprun_out"
SHAPE = {"B": 4, "S": 4096, "H": 48, "P": 64, "N": 128, "Q": 256}
KERNEL = re.compile(r"(ssd_\w+_kernel)")


def _pass_ms(fn, calls):
    """Device ms a call of each ``ssd_*_kernel`` over ``calls`` eager
    calls under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from profile_epoch import _event_device_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = KERNEL.search(e.key)
        us = _event_device_us(e)
        if m and us > 0 and str(getattr(e, "device_type", "")).endswith(
                "CUDA"):
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / 1e3 / calls
    return dict(sorted(out.items()))


def run_one(root: pathlib.Path, groups) -> dict:
    import torch
    sys.path.insert(0, str(root / "src"))
    from chip_smoke import _graph_ms, _randn, _ssd_backward_issued, \
        _time_ms
    from profile_clear import _card
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    B, S, H, P, N, Q = (SHAPE[k] for k in "BSHPNQ")
    args = SR.sample_inputs(B, S, H, P, N, 33, dev, torch.bfloat16)
    g_y = _randn((B, S, H, P), 34, dev, torch.bfloat16)
    takes_groups = "groups" in inspect.signature(
        SK.ssd_scan_backward_cuda).parameters
    source = (root / "src" / "repro_torch" / "csrc" / "ssd_scan.cu")
    design = "group" if "ssd_bwd_bc_kernel" in source.read_text() \
        else "head"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    default = SK._groups(B, S, H, Q, sms) if takes_groups \
        else SK._groups(B, S, H, Q, dev)

    def call(i, g=None):
        if g is None:
            return SK.ssd_scan_backward_cuda(*args, Q, g_y, None)
        return SK.ssd_scan_backward_cuda(*args, Q, g_y, None, groups=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    first = call(0)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    again = call(1)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    del first, again
    row = {"root": str(root), "card": _card(), "design": design,
           "shape": {**SHAPE, "dtype": "torch.bfloat16", "g_state": None},
           "groups": default,
           "issued_products": _ssd_backward_issued(
               B, S, H, P, N, Q, default, 2, design),
           "ms": _graph_ms(call, 10), "ms_eager": _time_ms(call, 10),
           "peak_extra_gb": peak, "bit_equal_run_to_run": same,
           "pass_device_ms": _pass_ms(call, 5)}
    if groups:
        if not takes_groups:
            raise SystemExit(f"{root}: ssd_scan_backward_cuda takes no "
                             "groups")
        row["ms_by_groups"] = {
            str(g): _graph_ms(lambda i, g=g: call(i, g), 10) for g in groups}
        row["issued_products_by_groups"] = {
            str(g): _ssd_backward_issued(B, S, H, P, N, Q, g, 2, design)
            for g in groups}
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose repro_torch is timed")
    ap.add_argument("--compare", type=pathlib.Path, default=None,
                    help="another checkout: run it, here, here, it")
    ap.add_argument("--groups", type=int, nargs="*", default=[],
                    help="head-group counts to time besides the default")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_ssd needs a CUDA device")
    if a.compare is None:
        rows = [run_one(a.root.resolve(), a.groups)]
    else:
        rows = []
        for root in (a.compare, HERE, HERE, a.compare):
            cmd = [sys.executable, str(HERE / "profile_ssd.py"), "--root",
                   str(root.resolve())]
            if root is HERE and a.groups:
                cmd += ["--groups", *map(str, a.groups)]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=900)
            if res.returncode != 0:
                raise SystemExit(f"profile_ssd failed for {root}:\n"
                                 f"{res.stderr[-4000:]}")
            rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
    lines = [json.dumps(r) for r in rows]
    for line in lines:
        print(line, flush=True)
    if a.compare is None:             # a comparison's runs wrote theirs
        OUT.mkdir(exist_ok=True)
        with open(OUT / "profile_ssd.jsonl", "a") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
