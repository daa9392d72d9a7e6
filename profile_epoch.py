#!/usr/bin/env python3
"""Where the 10k fleet epoch's time goes on the card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 profile_epoch.py

Drives the main path of ``chip_smoke.py`` (``FLEET_10K`` in
``repro_torch.sim.simulator``: 10,000 leaves, 1,000 tenants, k=16, 21
epochs) through ``EpochRunner.drive`` twice on CUDA:

1. Phase times.  The epoch's callees (``Fleet.policy``,
   ``BatchEngine.cancel_all``, ``BatchEngine.step``, ``Fleet.after_step``
   and ``Fleet.advance``) are wrapped on their instances, so each call is
   synchronised before and after and timed on the host clock; ``other_ms``
   is the rest of the epoch (the stats update).  Each epoch also records
   its orders, cascade waves and clearing-kernel launches.
2. ``torch.profiler`` over epochs 1 and 2 (the heaviest): the sum of
   device kernel time against wall time (the device's busy share), the
   number of kernel launches and of device-to-host reads, the clearing
   kernel's launches and device time (in all and per cascade wave), and
   the top operations by device and by host time.

Prints one JSON line per result and writes them to
``chiprun_out/profile_epoch.jsonl``.  Needs CUDA; it never runs on the CPU.
"""
from __future__ import annotations

import functools
import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
PHASES = (("fleet", "policy"), ("eng", "cancel_all"), ("eng", "step"),
          ("fleet", "after_step"), ("fleet", "advance"))
PROFILED_EPOCHS = (1, 2)
CLEAR_TAG = "clear_tree_kernel"      # the clearing kernel's CUDA name


def _scenario(dev):
    from repro_torch.sim.epoch import EpochRunner
    from repro_torch.sim.simulator import FLEET_10K, FleetScenarioConfig, \
        _seed_floors, make_fleet
    fcfg = FleetScenarioConfig(**FLEET_10K)
    topo, _, market, fleet, params = make_fleet(fcfg, dev)
    _seed_floors(market, topo)
    return fcfg, EpochRunner(market, fleet), params


def _drive(fcfg, runner, params):
    state = runner.fleet.init_state(params)
    _, epoch_s, _ = runner.drive(params, state, fcfg.duration_s, fcfg.tick_s)
    return epoch_s


def phase_times(dev):
    """Per-epoch host time of each phase, synchronised around each."""
    import torch
    from repro_torch.kernels.market_clear import kernel as K
    fcfg, runner, params = _scenario(dev)
    rows = []

    def timed(obj, name):
        fn = getattr(obj, name)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if name == "policy":            # the first call of an epoch
                rows.append({"epoch": len(rows)})
            row = rows[-1]
            if name == "step":
                waves0, launches0 = int(args[0]["waves"]), K.LAUNCHES
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            row[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
            if name == "policy":
                row["orders"] = int((out[3]["tenant"] >= 0).sum())
            if name == "step":
                row["waves"] = int(out[0]["waves"]) - waves0
                row["launches"] = K.LAUNCHES - launches0
            return out
        setattr(obj, name, wrapper)

    for owner, name in PHASES:
        timed(getattr(runner, owner), name)
    epoch_s = _drive(fcfg, runner, params)
    for row, s in zip(rows, epoch_s):
        row["epoch_ms"] = s * 1e3
        row["other_ms"] = row["epoch_ms"] - sum(
            row[f"{name}_ms"] for _, name in PHASES)
    return rows


def _event_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def trace_epochs(dev):
    """torch.profiler over ``PROFILED_EPOCHS`` of a fresh run: epoch 0
    warms the profiler up, and ``prof.step()`` runs as each epoch starts."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels.market_clear import kernel as K
    fcfg, runner, params = _scenario(dev)
    traced = {}
    prof = profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=PROFILED_EPOCHS[0],
                          active=len(PROFILED_EPOCHS), repeat=1),
        on_trace_ready=lambda p: traced.update(events=p.key_averages()))
    policy, started = runner.fleet.policy, []

    def stepping_policy(*args, **kwargs):
        if started:
            prof.step()
        started.append(K.LAUNCHES)
        return policy(*args, **kwargs)
    runner.fleet.policy = stepping_policy
    with prof:
        epoch_s = _drive(fcfg, runner, params)
    first, last = PROFILED_EPOCHS[0], PROFILED_EPOCHS[-1]
    wall_ms = sum(epoch_s[first:last + 1]) * 1e3
    out = {"profiled_epochs": list(PROFILED_EPOCHS), "wall_ms": wall_ms,
           "waves": started[last + 1] - started[first]}
    events = traced["events"]
    out.update(summarize(events, wall_ms, (CLEAR_TAG,)))
    clear_ms = sum(_event_device_us(e) for e in events
                   if CLEAR_TAG in e.key) / 1e3
    out.update({f"{CLEAR_TAG}_device_ms": clear_ms,
                f"{CLEAR_TAG}_device_ms_per_wave":
                    clear_ms / out["waves"] if out["waves"] else None})
    return out


def summarize(events, wall_ms, kernel_tags):
    """Device busy time and share, kernel launches, device-to-host
    reads, the launches of the kernels whose names hold each of
    ``kernel_tags``, and the top operations by device and by host time,
    from a profiler's ``key_averages()``."""
    dev_rows, host_rows = [], []
    launches = reads = 0
    for e in events:
        dus = _event_device_us(e)
        # each ProfilerStep also lands on the device track as an
        # annotation spanning the whole step: it is not device work
        if (str(getattr(e, "device_type", "")).endswith("CUDA") and dus > 0
                and not e.key.startswith("ProfilerStep")):
            dev_rows.append((dus, e.key, e.count))
        else:
            host_rows.append((float(e.self_cpu_time_total), e.key, e.count))
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                     "cudaLaunchKernelExC"):
            launches += e.count
        if e.key == "aten::_local_scalar_dense":
            reads += e.count
    busy_ms = sum(r[0] for r in dev_rows) / 1e3
    dev_rows.sort(reverse=True)
    host_rows.sort(reverse=True)
    return {
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "kernel_launches": launches, "host_reads": reads,
        **{f"{tag}_launches": sum(r[2] for r in dev_rows if tag in r[1])
           for tag in kernel_tags},
        "top_device": [{"name": k[:90], "ms": us / 1e3, "count": c}
                       for us, k, c in dev_rows[:10]],
        "top_host_self": [{"name": k[:90], "ms": us / 1e3, "count": c}
                          for us, k, c in host_rows[:10]],
    }


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_epoch needs a CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    rows = phase_times(dev)
    keys = [f"{name}_ms" for _, name in PHASES] + [
        "other_ms", "epoch_ms", "waves", "launches"]
    totals = {k: sum(r[k] for r in rows[1:]) for k in keys}
    out = [{"phase_times": rows},
           {"phase_totals_after_epoch0": totals,
            "card": card},
           {"profile": trace_epochs(dev)}]
    lines = [json.dumps(o) for o in out]
    for line in lines:
        print(line, flush=True)
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "profile_epoch.jsonl").write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
