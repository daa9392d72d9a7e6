#!/usr/bin/env python3
"""The Trainer's full-width train step on the card, through the user's
entry point.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 profile_trainer.py [--arch olmoe-1b-7b | mamba2-780m]
    python3 profile_trainer.py --compare DIR   # DIR, here, here, DIR, twice

Runs ``launch.train.train`` at ``chip_smoke.py``'s ``TRAIN_FULL`` for the
arch (full width, the Trainer on a one-rank (1, 1) NCCL mesh, 6 steps,
no checkpoint) and prints one JSON line: the host ms of each step (each
ending in the loss's host read), their median after the first, the
losses and the peak memory.  ``--compare DIR`` runs another checkout's
``repro_torch`` and this one's in turns, each in a fresh process, so
that two versions are compared within one call.  Lines go to
``chiprun_out/profile_trainer.jsonl``.  Needs CUDA; it never runs on the
CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

from chip_smoke import SERVE_ARCH, SSM_ARCH, TRAIN_FULL

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "chiprun_out"


def run_one(root: pathlib.Path, arch: str) -> dict:
    import torch
    sys.path.insert(0, str(root / "src"))
    from repro_torch.launch.train import train
    from repro_torch.optim import AdamWConfig
    spec = TRAIN_FULL[arch]
    opt = AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup_steps"],
                      state_dtype=spec["state_dtype"])
    with tempfile.TemporaryDirectory(dir=OUT) as ckpt:
        _, rep = train(arch, steps=spec["steps"], seq_len=spec["seq_len"],
                       global_batch=spec["batch"], full=True, ckpt_dir=ckpt,
                       opt=opt, checkpoint_every=spec["steps"] + 1)
    ms = [1e3 * s for s in rep.step_s]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"card": card, "root": str(root), "arch": arch, "step_ms": ms,
            "step_ms_p50": statistics.median(ms[1:]), "losses": rep.losses,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=SERVE_ARCH,
                    choices=(SERVE_ARCH, SSM_ARCH))
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose repro_torch is timed")
    ap.add_argument("--compare", type=pathlib.Path, default=None,
                    help="another checkout: it, here, here, it, twice")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_trainer needs a CUDA device")
    OUT.mkdir(exist_ok=True)
    if a.compare is None:
        rows = [run_one(a.root.resolve(), a.arch)]
    else:
        rows = []
        for root in (a.compare, HERE, HERE, a.compare) * 2:
            res = subprocess.run(
                [sys.executable, str(HERE / "profile_trainer.py"), "--arch",
                 a.arch, "--root", str(root.resolve())],
                capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise SystemExit(f"profile_trainer failed for {root}:\n"
                                 f"{res.stderr[-4000:]}")
            rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
    lines = [json.dumps(r) for r in rows]
    for line in lines:
        print(line, flush=True)
    if a.compare is None:             # a comparison's runs wrote theirs
        with open(OUT / "profile_trainer.jsonl", "a") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
