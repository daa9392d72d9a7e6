#!/usr/bin/env python3
"""Where a serving main path's time goes on the card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 profile_serve.py [--arch olmoe-1b-7b | mamba2-780m |
                              gemma3-27b | qwen3-0.6b | h2o-danube-1.8b]

Serves ``chip_smoke.py``'s serving main path once (the arch, default
``olmoe-1b-7b``, at full width, bfloat16, 8 requests of 1,024-token
prompts, 32 new tokens, 4 slots) to warm up, then, on the same server:

1. ``torch.profiler`` over one prefill (``Server._fill_slot``);
2. ``torch.profiler`` over 5 decode ticks with all 4 slots busy;

and reports for each the wall time, the device's busy share, the kernel
launches (and those of the model kernels: the decode kernel, the router
kernel for OLMoE, the SSD scan's three passes for mamba2), the device
time of each of those kernels, and the top operations by device and by
host time.  Prints one JSON line per result
and writes them to ``chiprun_out/profile_serve-<arch>.jsonl``.  Needs
CUDA; it never runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

from chip_smoke import DENSE_ARCH, SERVE_ARCH, SERVE_FULL, SSM_ARCH
from profile_epoch import _event_device_us, summarize

HERE = pathlib.Path(__file__).resolve().parent
DECODE_TICKS = 5
TAGS = ("decode_split_kernel", "route_kernel", "ssd_chunk_state_kernel",
        "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")


def _profiled(fn, dev):
    """Run ``fn`` once under torch.profiler; wall ms and the summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernel_ms = {tag: sum(_event_device_us(e) for e in events
                          if tag in e.key) / 1e3 for tag in TAGS}
    return {"wall_ms": wall_ms, **summarize(events, wall_ms, TAGS),
            "kernel_device_ms": kernel_ms}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=SERVE_ARCH,
                    choices=(SERVE_ARCH, SSM_ARCH, DENSE_ARCH, "qwen3-0.6b",
                             "h2o-danube-1.8b"))
    arch = ap.parse_args().arch
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.launch.serve import serve
    from repro_torch.serve.server import Request
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    rep = serve(arch, full=True, device=dev, **SERVE_FULL)
    srv = rep.server
    rng = np.random.default_rng(1)
    reqs = [Request(rid=100 + i, max_new=SERVE_FULL["max_new"],
                    prompt=rng.integers(0, rep.cfg.vocab_size,
                                        SERVE_FULL["prompt_len"])
                    .astype(np.int32)) for i in range(srv.B)]
    out = [{"card": card, "arch": arch, "warm_up": rep.metrics()}]
    out.append({"prefill": _profiled(lambda: srv._fill_slot(0, reqs[0]),
                                     dev)})
    for i in range(1, srv.B):
        srv._fill_slot(i, reqs[i])
    srv.step()                                  # all slots busy, warm

    def ticks():
        for _ in range(DECODE_TICKS):
            srv.step()
    res = _profiled(ticks, dev)
    res["ticks"] = DECODE_TICKS
    res["ms_per_tick"] = res["wall_ms"] / DECODE_TICKS
    res["launches_per_tick"] = res["kernel_launches"] / DECODE_TICKS
    out.append({"decode": res})
    lines = [json.dumps(o) for o in out]
    for line in lines:
        print(line, flush=True)
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"profile_serve-{arch}.jsonl").write_text("\n".join(lines)
                                                       + "\n")


if __name__ == "__main__":
    main()
