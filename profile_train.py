#!/usr/bin/env python3
"""Where a full-width train step's time goes on the card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 profile_train.py [--arch olmoe-1b-7b | mamba2-780m]

Builds ``chip_smoke.py``'s training main path for the arch (full width,
bfloat16 parameters from ``torch.Generator`` seed 0 on the card, the
``TRAIN_FULL`` batch, AdamW state and learning rate, remat on; the
trainer's step over a one-rank (1, 1) mesh, so the MoE layers run
``moe_ep``), takes 2 steps to warm up, then:

1. three steps split into their parts on the host clock, each part
   ended by a synchronise: the forward and loss (``loss_fn``), the
   backward (``torch.autograd.grad``: the remat recompute, the
   Functions' backwards) and ``adamw_update``; medians in ms;
2. ``torch.profiler`` over one more step: the wall time, the device's
   busy share, the kernel launches (and the router's and the SSD
   scan's, its backward's passes by name; the backward's first pass
   runs the forward's ``ssd_chunk_state_kernel`` twice and counts
   there), the device ms of the GEMMs, of the model kernels and of the
   rest, and the top operations by device and by host time.

Prints one JSON line per result and writes them to
``chiprun_out/profile_train-<arch>.jsonl``.  Needs CUDA; it never runs
on the CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

from chip_smoke import SERVE_ARCH, SSM_ARCH, TRAIN_FULL
from profile_epoch import _event_device_us, summarize

HERE = pathlib.Path(__file__).resolve().parent
TAGS = ("route_kernel", "ssd_chunk_state_kernel", "ssd_state_pass_kernel",
        "ssd_chunk_scan_kernel", "ssd_state_grad_kernel",
        "ssd_bwd_col_kernel", "ssd_bwd_row_kernel", "ssd_bwd_dt_kernel",
        "ssd_bwd_sum")
GEMM_TAGS = ("gemm", "nvjet", "cutlass", "sm90_xmma")


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=SERVE_ARCH,
                    choices=(SERVE_ARCH, SSM_ARCH))
    arch = ap.parse_args().arch
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig, adamw_update, make_train_state
    from repro_torch.tree import tree_leaves, tree_map
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    spec = TRAIN_FULL[arch]
    opt = AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup_steps"],
                      state_dtype=spec["state_dtype"])
    data = SyntheticTokens(DataConfig(cfg.vocab_size, spec["seq_len"],
                                      spec["batch"], 0))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()} for i in range(6)]
    state = make_train_state(M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev), opt)
    mi = M.MeshInfo(make_mesh((1, 1), ("data", "model"), dev), ("data",),
                    "model")
    step = S.make_train_step(cfg, opt, mi)
    moe_fn = S.make_moe_fn(mi)
    warmup_ms = []
    for b in batches[:2]:
        t0 = time.perf_counter()
        state, m = step(state, b)
        float(m["loss"])
        warmup_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize(dev)

    parts = {"forward_loss_ms": [], "backward_ms": [], "adamw_ms": []}
    for b in batches[2:5]:
        leaves = tree_leaves(state["params"])
        t0 = time.perf_counter()
        loss = M.loss_fn(state["params"], cfg, b, moe_fn)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        grads = iter(torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        state, _ = adamw_update(state, tree_map(lambda _: next(grads),
                                                state["params"]), opt)
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
        del grads, loss          # the iterator holds the gradients
    out = [{"card": card, "arch": arch, **{k: spec[k] for k in (
                "batch", "seq_len", "state_dtype")},
            "warmup_step_ms": warmup_ms,
            "parts_median": {k: _median(v) for k, v in parts.items()},
            "parts_all": parts}]

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batches[5])
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [(e.key, _event_device_us(e) / 1e3) for e in events
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and _event_device_us(e) > 0]
    gemm_ms = sum(ms for k, ms in device
                  if any(t in k.lower() for t in GEMM_TAGS))
    kernel_ms = {tag: sum(ms for k, ms in device if tag in k)
                 for tag in TAGS}
    res = {"wall_ms": wall_ms, **summarize(events, wall_ms, TAGS),
           "gemm_device_ms": gemm_ms, "kernel_device_ms": kernel_ms}
    res["other_device_ms"] = (res["device_busy_ms"] - gemm_ms
                              - sum(kernel_ms.values()))
    out.append({"profiled_step": res})
    lines = [json.dumps(o) for o in out]
    for line in lines:
        print(line, flush=True)
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"profile_train-{arch}.jsonl").write_text("\n".join(lines)
                                                       + "\n")


if __name__ == "__main__":
    main()
