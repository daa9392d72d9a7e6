#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (one JSON line each):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA source under ``src/repro_torch/csrc``, one nvcc per source, all
   started together;
2. every kernel against its plain PyTorch version on the same CUDA
   tensors at the shapes its main path gives it (market_clear
   ``torch.equal``; decode_attention within 2e-5 in float32 and 3e-2 in
   bfloat16; moe_route indices equal and weights within rtol 1e-5 /
   atol 1e-6, its dense combine weights (float32 and bfloat16) equal
   bit for bit to the scatter of its own weights and indices, and
   within that weight tolerance (float32) or one bfloat16 step of the
   plain version's; ssd_scan's y within 3e-4 in float32 and 4e-2 in bfloat16,
   its float32 final state within 3e-4, at the mamba2 serving shape, a
   partial last chunk, B 2 and a reference sweep shape; decode_attention
   again at every ``DECODE_SHAPES`` model shape: gemma3's windowed and
   global layers, qwen3, danube's head dim 80 under its 4,096 window,
   paligemma's MQA at head dim 256, whisper's self- and
   cross-attention), the whole fleet slice at a small size on the card
   against the same run on the CPU (identical state, perf and stats),
   and seven reduced models on the card against the same runs on the
   CPU in float32 (the same tokens, the last logits within 1e-4, every
   launch count exact): the OLMoE and mamba2 servers, the qwen3, gemma3,
   danube, jamba and kimi servers on 20-token prompts (past the reduced
   window of 16), and paligemma and whisper through prefill and 8
   decode steps;
2a. ``decode_cut``: the decode kernel's partial mode over one full-width
   bfloat16 cache cut into 2, 4 and 8 blocks, as a mesh whose "model"
   axis cuts the KV sequence gives each rank one (``DECODE_CUT``:
   gemma3-27b's global layer, B 4, S 32,768, K 16, G 2, hd 128; its
   windowed layer, window 1,024; jamba-v0.1-52b's, B 4, S 8,192, K 8, G
   4): each block's partial through ``ops.partial`` (one launch a block,
   counted from 0), each block's float32 (o, m, l) held against the
   plain partial on the same block within 2e-5 (a block with no valid
   position reporting m = -2**30 and l its length exactly), then
   ``merge_partials``, the function the collective route calls after its
   all-gather, held against the whole-cache kernel and the plain version
   within 2e-3 plus one bfloat16 step of the value; then graph ms of the
   partial call on one of 4 blocks (fully valid) and of the merge,
   beside the whole-cache kernel, SDPA over the whole cache's valid
   range, the library's block attention with its logsumexp on the same
   block (``library_ms``) and the bound (the block's bytes over 3.35
   TB/s);
3. the fleet main path: ``run_fleet_scenario`` on ``FLEET_10K`` (10,000
   leaves, 1,000 tenants, 21 epochs, the engine-sampled retention
   denominator: 12 single-tenant alone runs after the drive), with
   every launch count set to 0 just before and read just after; the
   clearing kernel must run once per cascade wave of the drive and of
   every alone run; orders, transfers and mean retention are held to
   the committed ``BENCH_fig06.json`` row;
3a. ``state_checker``: the port's state checker
   (``market_torch/schema.py``) on the card: ``validate_state`` on
   phase 3's final 10k engine state (clean; ms, median of 5, host clock
   ending in its one host read; kernel launches and copies from
   ``torch.profiler``); ``LAISSEZ_VALIDATE=1`` through the hooked paths
   (the 256-leaf fleet through ``EpochRunner``, a ``CrashSafeRunner`` run
   and resume, a facade's 40-event trace and three ``step_arrays``): one
   validation per publish or step, none raising; then every break case
   of ``tests/torch_schema_cases.py`` on a card copy of its clean state,
   each raising its error with the CPU's message; then two epochs of the
   256-leaf fleet on the card through ``schema.trace_epoch``
   (``trace_effects`` for ``EpochRunner.epoch``, and for
   ``BatchEngine.step`` inside it): the observed write-sets, printed,
   within the declared ones;
3b. ``fig06_scale``: the fcfs / fcfsp / spot fleet baselines
   (``run_fleet_baseline``) at n=10,000 on phase 3's cached denominator,
   then the n=2,048 case (laissez with the analytic denominator and the
   three baselines); every retention (three decimals), grant and
   preemption count and degradation reduction is held to the committed
   ``BENCH_fig06.json`` rows; the baselines clear no book, so they
   launch no kernel;
3c. ``faults``: the ``BENCH_fig_faults.json`` n=10,000 pair (16 epochs,
   no faults, then a rack-failure storm and a zone supply shock), held
   to its revoked_by_fault counts, the clearing kernel once per wave;
   the storm run's engine state, perf and stats held to the same run on
   the CPU (that row's transfers and retention predate the reference's
   calibrated fleet and are printed beside, not held); then the kernel
   against its plain version on the storm's final book, under its own
   health and under the storm's mid-run health with two racks draining;
3d. ``recovery``: ``benchmarks/fig_faults.py``'s recovery row on the
   card — the same storm through ``CrashSafeRunner`` (a snapshot every 5
   epochs, a WAL record every epoch) killed at the final epoch's
   post_step, then one cold and three warm ``resume``s from pristine
   copies of its workdir, each replaying 5 epochs and equal to 3c's
   storm run (owners, rates, bills, health, performance, stats), the
   clearing kernel once per wave; then the 64-leaf chaos sweep of
   ``tests/test_recovery.py`` (a kill at each of the five phases and at
   epoch 0, each resumed) equal to the uninterrupted card run and to the
   same run on the CPU;
3e. ``event_path``: ``run_with_retention("laissez_batch")`` on the card
   (every facade call one engine step) at ``PARITY_CFG`` for the three
   regimes, each mean retention equal to the committed
   ``fig06/parity/*/laissez_batch`` row and to the event ``Market``'s
   run (batch minus event +0.000), the kernel at least once per step,
   with each call's time split into the engine step (ended by a
   synchronise), the packed host copy and the rest;
   a ``tests/test_differential.py`` trace on the card's facade and on
   the CPU's, equal after every event; ``clear`` / ``clear_topk`` on
   the card equal to the CPU on the trace's final book and on 3c's
   10k storm book;
4. the serving main paths: ``repro_torch.launch.serve.serve`` on
   ``olmoe-1b-7b`` and then on ``mamba2-780m``, each at full width
   (bfloat16, random weights from ``torch.Generator`` seed 0), 8
   requests of 1,024-token prompts, 32 new tokens each, 4 slots, with
   every launch count set to 0 just before and read just after each;
   every request must get 32 tokens and the logits must be finite;
   OLMoE must run decode_attention 16 times a decode step and moe_route
   16 times a prefill or decode step, mamba2 ssd_scan 48 times a
   prefill, and neither path any other kernel; each reports time to
   first token, decode ms per step and output tokens per second;
4b. this slice's main path, ``gemma3-27b`` served at full width (27.0 B
   bfloat16 parameters, the same traffic): every request 32 tokens in
   the vocabulary, finite logits, decode_attention 62 times a decode
   step (52 of them within the window of 1,024) and no other kernel,
   with peak memory, the init's own peak, time to first token, decode
   ms per step and tokens per second; then ``qwen3-0.6b`` on the same
   traffic and ``h2o-danube-1.8b`` on ``DANUBE_SERVE`` (4,160-token
   prompts, past its window), with the same checks; then
   ``paligemma-3b`` and ``whisper-base`` at full width, which the
   Server cannot feed, through prefill and 8 greedy decode steps
   (``FRONTEND_FULL``: B 2, 16 text tokens, 256 seeded patch or 1,500
   frame embeddings): finite logits, tokens in the vocabulary,
   decode_attention once per self- and cross-attention layer per step;
   each model is freed before the next;
4c. the training main paths, on the trainer's one-rank (1, 1) mesh
   (one NCCL group over a ``HashStore``; the MoE layers run the
   reference's capacity-limited ``moe_ep``):
   ``train_kernels_vs_plain``: the router Function's logits gradient on
   the card against the same Function's on the CPU (tied logits) and
   against autograd through the plain version on the card (untied),
   within 1e-6, at T 1,024 and 4,096, E 64, k 8, renormalised or not,
   float32 and bfloat16 dense weights; the SSD Function's gradients of
   the conv output, dt and A through the SSD backward kernel (one
   launch each) against the CPU's within 3e-4 (float32) at reduced
   mamba2's shape and one full-width mamba2 layer's (1 x 4,096 x 48 x
   64); then both backwards at the training shapes: the router's time,
   and the SSD backward kernel against the plain version on the card in
   bfloat16 (``kernel.BWD_BF16_TOL`` of each gradient's largest magnitude)
   at mamba2-train's (4 x 4,096), its graph and eager time, bound and
   peak beside the plain version's time and peak;
   ``moe_ep_vs_plain``: one full-width OLMoE MoE layer (``MOE_EP_LAYER``:
   T 4,096, bfloat16, 640 slots an expert) through ``moe_ep`` on the
   card and on the CPU: ``buf_tok`` and the per-expert counts exactly
   equal, the output within 3e-2, every gradient within 3e-2 of the
   CPU's largest, the dropped share printed;
   ``reduced_train_*``: reduced OLMoE, mamba2 and jamba (float32) take
   3 ``make_train_step`` steps over the mesh on the card and on the CPU:
   every first-step gradient leaf within atol 1e-5 + rtol 1e-3 and
   non-zero, the losses within 1e-4, the launches exact; ``train_olmoe``
   and ``train_mamba2``: ``olmoe-1b-7b`` (1 x 4,096 tokens, bfloat16 m
   and v: float32 ones do not fit) and ``mamba2-780m`` (4 x 4,096,
   float32 m and v) at full width through ``launch.train.train`` and
   ``Trainer.run`` (``TRAIN_FULL``, 6 steps, a checkpoint interval
   longer than the run), every launch count set to 0 just before and
   read just after and equal to ``_train_launches`` (moe_route or
   ssd_scan twice per layer a step: the forward and the remat
   recompute; the SSD backward kernel once per SSD layer a step, as
   often as ``_SSDScan.backward`` is called, and the plain backward
   never; no other kernel), finite losses, step ms p50 / p95 after
   the first step, tokens/s, peak memory and ``moe_ep``'s dropped share;
   then one more step's gradients outside the Trainer on its mesh, every
   leaf (every row of a stacked one) finite and non-zero, the router,
   ``A_log``, ``dt_bias``, ``conv_w`` and ``in_proj`` leaves named;
   ``launch_train_market``: ``launch.train.market_scenario``
   (``tests/test_system.py``'s rival-outbids-then-leaves scenario, 24
   steps in three runs, each resumed from a checkpoint) with reduced
   OLMoE on the card (``max_devices`` 1) against the CPU, each run from
   the same checkpoint: losses within 1e-5, a restore per run, the router's
   launches exact (one card holds one NCCL rank: the resizes run on
   CPU gloo ranks in ``tests/test_torch_launch.py``);
4d. the sharded step and the dry run: ``sharded_train``: olmoe-1b-7b's
   ``TRAIN_FULL`` through ``make_train_step`` on plain tensors, then with
   the state as DTensors placed by ``train_state_specs`` on the same
   one-rank (1, 1) mesh from the same seeded parameters and batches:
   each step's loss and grad norm within 1e-6 relative, moe_route's
   launches in the DTensor run exact, its peak under 72 GB, step ms
   p50 / p95 of both beside ``train_olmoe``'s, and the dry run's
   tensor-core floor of the step (rank 0's matrix FLOPs from a trace in
   a fake-group subprocess, over 989 TFLOP/s); ``dryrun``: four
   full-width cells (``DRYRUN_CELLS``) through ``python -m
   repro_torch.launch.dryrun``, each in its own host process with no
   card visible, all at once: every cell ``ok``, its per-device FLOPs
   and bytes, wire bytes by collective, analytic memory and
   ``fits_h100``, uneven leaves and the host's trace seconds; the card's
   ``total_memory`` equal to ``analytic.HBM_BYTES``;
5. a ``kernels`` line: per kernel, its launches on its main path, its
   time per call, the plain version's time and one PyTorch library
   call's time on the same inputs (none computes the SSD scan), and the
   least time the card could take (bytes over 3.35 TB/s, or operations
   over the rate for their type, whichever is larger; the SSD scan's at
   the bf16 tensor-core rate, with the figure at the float32 rate of the
   CUDA cores beside it as ``bound_ms_fp32_cores``), and
   decode_attention's split plan and, under ``partial``, phase 2a's
   partial mode (its launches, error, graph ms, bound, plain ms; the
   merge's, the whole-cache kernel's and SDPA's ms beside); for
   moe_route also the logits product
   and, after it, the router sequence and the library's
   (``_route_timings``).  Times are CUDA events over calls captured in a
   CUDA graph (device time; the eager times, host enqueue included,
   stand beside them as ``*_ms_eager``); market_clear's plain version
   reads the device, so it cannot be captured and its time is eager.
   decode_attention's entry holds the OLMoE shape and, under ``paths``,
   the gemma3 windowed, danube, paligemma and whisper cross shapes on
   their own caches (each with its launches, times, bound over the
   valid window's bytes and SDPA on the same range); its
   ``launches_by_path`` counts every serving path's launches, and
   moe_route's and ssd_scan's count their serving and training paths';
   moe_route's also carries its backward's route and time
   (``backward``).  The SSD backward kernel has an entry of its own
   (``ssd_scan_backward``: its launches on mamba2-train, its bfloat16
   error against the plain version, graph and eager ms, bound, peak;
   the plain version's ms, eager, and peak).

Each phase's wall seconds and the total stand on the ``done`` line.
The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
nonzero before it; without CUDA, or without the repository beside it,
the script exits nonzero and prints no result.  Float32 products run
without TF32 (both ``allow_tf32`` switches off).
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "chiprun_out"

# the committed reference row fig06/scale/fused_epoch/backend=jnp/n=10000
# (BENCH_fig06.json): deterministic results the port must reproduce
COMMITTED_10K = {"orders": 52310, "transfers": 14123, "epochs": 21,
                 "mean_retention": "0.954"}
# benchmarks/fig06_contention.py SCALE_CASES' 2,048 case and its committed
# row fig06/scale/fused_epoch/backend=jnp/n=2048
FLEET_2048 = dict(regime="heavy", n_leaves=2048, n_training=96,
                  n_inference=96, n_batch=64, duration_s=1800.0,
                  tick_s=60.0, seed=1, k=16, b_max=2048, alone="analytic")
COMMITTED_2048 = {"orders": 19005, "transfers": 3591, "epochs": 31,
                  "mean_retention": "0.818"}
# the committed fig06/scale/baseline={kind}/n={n} rows: (mean retention,
# grants, preemptions), and fig06/scale/degradation_reduction_vs_{kind}
COMMITTED_BASELINES = {
    10000: {"fcfs": ("0.912", 14698, 0), "fcfsp": ("0.785", 23424, 6347),
            "spot": ("0.994", 12752, 1495)},
    2048: {"fcfs": ("0.741", 3345, 0), "fcfsp": ("0.613", 5402, 1451),
           "spot": ("0.732", 3027, 670)}}
COMMITTED_REDUCTION = {
    10000: {"fcfs": "47.7%", "fcfsp": "78.7%", "spot": "-658.2%"},
    2048: {"fcfs": "29.9%", "fcfsp": "53.1%", "spot": "32.4%"}}
# benchmarks/fig_faults.py's 10k case (15 epochs of 60 s, so 16 ticks)
# and its committed fig_faults/{nofault,storm}/backend=jnp/n=10000 rows.
# Their transfers and retention predate the reference's calibrated fleet
# (docs/DESIGN.md §13; tests/test_torch_faults.py shows the same of the
# n=2,048 rows), so only the fault-driven counts are held to them; the
# storm run is held to the same run on the CPU instead.
FAULTS_10K = dict(regime="heavy", n_leaves=10000, n_training=384,
                  n_inference=384, n_batch=232, duration_s=900.0,
                  tick_s=60.0, seed=1, k=16, b_max=1024, alone="analytic")
COMMITTED_FAULTS = {
    "nofault": {"revoked_by_fault": 0, "epochs": 16},
    "storm": {"revoked_by_fault": 224, "epochs": 16}}
STALE_FAULT_ROWS = {"nofault": {"transfers": 15133, "mean_retention": 0.117},
                    "storm": {"transfers": 15102, "mean_retention": 0.121}}
# the whole fleet slice at the size of the repository's epoch tests
SMALL_FLEET = dict(regime="heavy", n_leaves=256, n_training=6,
                   n_inference=6, n_batch=4, duration_s=900.0, tick_s=60.0,
                   seed=3, k=8, b_max=128, per_tenant_bids=4,
                   alone="analytic")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM, float32 outside tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM, bf16 tensor cores, dense
SERVE_ARCH = "olmoe-1b-7b"
SSM_ARCH = "mamba2-780m"
DENSE_ARCH = "gemma3-27b"        # the dense / sliding-window main path
# the serving main paths: 8 requests of 1,024 tokens, 32 new, 4 slots
SERVE_FULL = dict(requests=8, prompt_len=1024, max_new=32, slots=4)
# h2o-danube-1.8b: prompts past its 4,096 window, so that the window cuts
# in prefill and in every decode step
DANUBE_SERVE = dict(requests=2, prompt_len=4160, max_new=16, slots=2)
# paligemma-3b and whisper-base, which the Server cannot feed (their
# frontends' embeddings): prefill of B 2 x 16 text tokens with 256 patch
# or 1,500 frame embeddings, then 8 greedy decode steps
FRONTEND_FULL = dict(batch=2, text_tokens=16, steps=8)
# the training main paths at full width: train_4k's 4,096-token rows (its
# 256-row batch is a pod's), 1 row for OLMoE and 4 for mamba2; OLMoE's
# float32 m and v (~83 GB with the rest) do not fit the card, bfloat16 do
TRAIN_FULL = {
    "olmoe-1b-7b": dict(batch=1, seq_len=4096, steps=6, lr=1e-3,
                        warmup_steps=1, state_dtype="bfloat16",
                        why="float32 m and v need ~83 GB with params and "
                            "grads (param_counts); bfloat16 ~55 GB"),
    "mamba2-780m": dict(batch=4, seq_len=4096, steps=6, lr=1e-3,
                        warmup_steps=1, state_dtype="float32",
                        why="the config's opt_dtype (float32; ~9.4 GB)")}
# decode_attention against its plain version at the new model paths'
# shapes: (path, B, S, K, G, hd, [(pos, window), ...])
DECODE_SHAPES = (
    ("gemma3", 4, 1064, 16, 2, 128, ((1054, 1024), (1054, 0), (1023, 1024),
                                     (1024, 1024))),
    ("qwen3", 4, 1064, 8, 2, 128, ((1054, 0),)),
    ("danube", 2, 4184, 8, 4, 80, ((4170, 4096), (4096, 4096), (4095, 4096))),
    ("paligemma", 2, 280, 1, 8, 256, ((279, 0), (272, 0))),
    ("whisper_self", 2, 24, 8, 1, 64, ((23, 0),)),
    ("whisper_cross", 2, 1500, 8, 1, 64, ((1499, 0),)),
)

# the decode kernel's partial mode over one full-width bfloat16 cache cut
# into R blocks (``DECODE_CUT_RANKS``), as the ranks of a mesh whose
# "model" axis cuts the KV sequence hold it: (path, B, S, K, G, hd,
# [(pos, window), ...]); the positions leave blocks fully valid, partly
# valid and fully masked, and one case no valid position at all
DECODE_CUT = (
    ("gemma3_global", 4, 32768, 16, 2, 128, ((20000, 0), (-1, 0))),
    ("gemma3_local", 4, 32768, 16, 2, 128, ((9000, 1024),)),
    ("jamba", 4, 8192, 8, 4, 128, ((1030, 0), (4106, 0))),
)
DECODE_CUT_RANKS = (2, 4, 8)
# each block's float32 (o, m, l) against the plain partial: the same
# float32 sums in another order; the merged bfloat16 output against the
# whole-cache kernel and the plain version: 2e-3 plus one bfloat16 step
# (2**-7) of the value, one rounding of float32 sums that differ in the
# last bits (measured at most 1.2e-4 on an H100)
PARTIAL_TOL = 2e-5
BF16_MERGE_TOL, BF16_STEP = 2e-3, 2.0 ** -7

_LINES = []


def emit(obj) -> None:
    line = json.dumps(obj)
    _LINES.append(line)
    print(line, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _kernel_counters():
    """name -> (wrapper module, its launch counter) of every kernel; the
    SSD scan's backward counts in a counter of its own."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.market_clear import kernel as MK
    from repro_torch.kernels.moe_route import kernel as RK
    from repro_torch.kernels.ssd_scan import kernel as SK
    return {"market_clear": (MK, "LAUNCHES"),
            "decode_attention": (DK, "LAUNCHES"),
            "moe_route": (RK, "LAUNCHES"), "ssd_scan": (SK, "LAUNCHES"),
            "ssd_scan_backward": (SK, "BACKWARD_LAUNCHES")}


def _reset_launches() -> None:
    for mod, attr in _kernel_counters().values():
        setattr(mod, attr, 0)


def _read_launches():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _kernel_counters().items()}


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
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        list(pool.map(build.build, names))         # raises on a failure
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


def _clear_pair(aggs, args, k, health=None):
    """Kernel and plain version on the same CUDA tensors (``args``:
    floors, level offsets, strides, owners, limits), each followed by
    the health mask when ``health`` is given."""
    import torch
    from repro_torch.kernels.market_clear import kernel as K
    from repro_torch.kernels.market_clear import ref as R
    plain = R.clear_sorted_from_aggs(aggs, *args, k)
    got = K.clear_cuda(*aggs, *args)
    torch.cuda.synchronize()
    if health is not None:
        floors, _, strides, owner, limit = args
        mask = (floors, strides, owner, limit)
        plain = R.apply_health_mask(health, *plain, *mask)
        got = R.apply_health_mask(health, *got, *mask)
    return plain, got


def _run_both(eng, st, health=None):
    aggs, floors = _clear_inputs(eng, st)
    return _clear_pair(aggs, (floors, eng.level_off, eng.tree.strides,
                              st["owner"], st["limit"]), eng.k, health)


def _final_book(est, n_leaves, k):
    """The clearing inputs of a run's final engine state: the sorted
    book's aggregates and ``(floors, level offsets, strides, owners,
    limits)``."""
    from repro_torch.kernels.market_clear import ref as R
    from repro_torch.market_torch.engine import build_tree
    tree = build_tree(n_leaves)
    n_seg = est["seg_start"].shape[0] - 1
    aggs = R._prefix_aggregates(est["order"], est["sorted_gseg"],
                                est["seg_start"], est["price"],
                                est["tenant"], est["seq"], n_seg, k)
    level_off, acc = [], 0
    for d in range(tree.n_levels):
        level_off.append(acc)
        acc += tree.nodes_at(d)
    return tree, aggs, (tuple(est["floor"]), tuple(level_off),
                        tree.strides, est["owner"], est["limit"])


def phase_kernel_vs_plain(dev):
    import numpy as np
    import torch
    from repro_torch.market_torch.engine import TreeSpec, build_tree
    names = ("rate", "best_level", "cand_slots", "truncated", "evict")
    cases = []
    for k in (1, 8, 16, 32):
        cases.append((f"n10000_k{k}", *_book(
            build_tree(10000), k, 100 + k, 8192, 1000, dev,
            root_frac=0.5, cap=16384), None))
    cases.append(("n768_k8", *_book(build_tree(768), 8, 11, 700, 9, dev),
                  None))
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


def _differing_keys(a, b):
    """Keys whose arrays differ between two engine states (numpy; the
    floors compared level by level, NaN equal to NaN)."""
    import numpy as np

    def same(x, y):
        if isinstance(x, tuple):
            return all(same(u, v) for u, v in zip(x, y))
        return np.array_equal(x, y, equal_nan=True)
    return [key for key in a if not same(a[key], b[key])]


def phase_small_slice(dev):
    """The whole slice on the card against the same run on the CPU
    (plain versions), at the size of the repository's epoch tests."""
    import numpy as np
    import torch
    from repro_torch.convert import to_numpy
    from repro_torch.sim.simulator import FleetScenarioConfig, \
        run_fleet_scenario
    cfg = FleetScenarioConfig(**SMALL_FLEET)
    gpu = run_fleet_scenario(cfg, device=dev)
    cpu = run_fleet_scenario(cfg, device="cpu")
    eg = to_numpy(gpu.engine_state)
    diff = _differing_keys(to_numpy(cpu.engine_state), eg)
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


def _randn(shape, seed, dev, dtype):
    import numpy as np
    import torch
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)


def _route_logits(T, E, seed, dev):
    """Random logits with every third token's experts tied in pairs."""
    import numpy as np
    import torch
    x = np.random.default_rng(seed).standard_normal((T, E)) \
        .astype(np.float32)
    x[::3] = np.repeat(x[::3, :(E + 1) // 2], 2, axis=1)[:, :E]
    return torch.from_numpy(x).to(dev)


def phase_model_kernels_vs_plain(dev):
    """decode_attention and moe_route against their plain versions at the
    serving main path's shapes (OLMoE: B 4, K 16, G 1, hd 128, S 1,064;
    the router at T 4 (decode), 1,024 (prefill) and 4,096 (a train step),
    E 64, k 8)."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.moe_route import kernel as RK
    from repro_torch.kernels.moe_route import ref as RR
    B, S, K, G, hd = 4, 1064, 16, 1, 128
    for dtype, tol in (("float32", 2e-5), ("bfloat16", 3e-2)):
        dt = getattr(torch, dtype)
        q = _randn((B, K, G, hd), 1, dev, dt)
        k = _randn((B, S, K, hd), 2, dev, dt)
        v = _randn((B, S, K, hd), 3, dev, dt)
        for pos, window in ((0, 0), (511, 0), (1024, 0), (1054, 0),
                            (1063, 0), (1054, 256), (100, 256)):
            got = DK.decode_attention_cuda(q, k, v, pos, window)
            want = DR.decode_attention_ref(q, k, v, pos, window)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                     atol=tol))
            emit({"phase": "kernel_vs_plain", "kernel": "decode_attention",
                  "case": f"{dtype}_pos{pos}_win{window}",
                  "shape": [B, S, K, G, hd], "max_abs_err": err,
                  "tolerance": tol, "ok": ok})
            if not ok:
                fail(f"decode_attention differs from its plain version: "
                     f"{dtype} pos {pos} window {window}, max err {err}")
    for T in (4, 1024, 4096):
        for renorm in (False, True):
            logits = _route_logits(T, 64, T, dev)
            w, idx = RK.route_cuda(logits, 8, renorm)
            w0, idx0 = RR.route_ref(logits, 8, renorm)
            torch.cuda.synchronize()
            same_idx = bool(torch.equal(idx, idx0))
            err = float((w - w0).abs().max())
            ok = same_idx and bool(torch.allclose(w, w0, rtol=1e-5,
                                                  atol=1e-6))
            emit({"phase": "kernel_vs_plain", "kernel": "moe_route",
                  "case": f"T{T}_E64_k8_renorm{int(renorm)}_ties",
                  "indices_equal": same_idx, "max_abs_err": err,
                  "tolerance": {"rtol": 1e-5, "atol": 1e-6}, "ok": ok})
            if not ok:
                fail(f"moe_route differs from its plain version: T {T} "
                     f"renormalize {renorm}, indices equal {same_idx}, "
                     f"max err {err}")
            for dt in (torch.float32, torch.bfloat16):
                _check_route_dense(logits, 8, renorm, dt, f"T{T}_E64_k8_"
                                   f"renorm{int(renorm)}_ties")


def _bf16_steps(a, b) -> int:
    """Largest distance, in bfloat16 steps, between two arrays of
    bfloat16 values that are all >= +0."""
    import torch
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max()) if a.numel() else 0


def _check_route_dense(logits, k, renorm, dt, case):
    """The router's dense combine weights: equal, bit for bit and with no
    -0.0, to the scatter of the kernel's own w and idx in ``dt``; against
    the plain version, the weight tolerance (rtol 1e-5 / atol 1e-6) in
    float32, and in bfloat16 at most one bfloat16 step (relative 2^-7:
    a weight one float32 ulp away may round to the neighbour)."""
    import torch
    from repro_torch.kernels.moe_route import kernel as RK
    from repro_torch.kernels.moe_route import ref as RR
    w, idx, dense = RK.route_cuda(logits, k, renorm, dt)
    _, idx0, dense0 = RR.route_dense_ref(logits, k, renorm, dt)
    own = torch.zeros(dense.shape, dtype=torch.float32, device=w.device)
    own.scatter_(1, idx.long(), w)
    torch.cuda.synchronize()
    exact = bool(torch.equal(dense.view(torch.uint8),
                             own.to(dt).view(torch.uint8))
                 and not torch.signbit(dense.float()).any()
                 and torch.equal(idx, idx0))
    err = float((dense.float() - dense0.float()).abs().max())
    if dt == torch.float32:
        tol = {"rtol": 1e-5, "atol": 1e-6}
        close = bool(torch.allclose(dense, dense0, **tol))
    else:
        tol = {"bf16_steps": 1}
        close = _bf16_steps(dense, dense0) <= 1
    emit({"phase": "kernel_vs_plain", "kernel": "moe_route",
          "case": f"dense_{str(dt)[6:]}_{case}",
          "dense_equals_own_scatter": exact, "max_abs_err": err,
          "tolerance": tol, "ok": exact and close})
    if not (exact and close):
        fail(f"moe_route's dense weights ({dt}, {case}): equal to the "
             f"scatter of its own w and idx {exact}, within {tol} of the "
             f"plain version {close} (max err {err})")
    return err


def phase_ssd_vs_plain(dev):
    """ssd_scan against its plain version: mamba2's serving shape (B 1,
    S 1,024, H 48, P 64, N 128, Q 256), a partial last chunk (S 1,000),
    B 2, the reference sweep shape (2, 512, 8, 64, 128, Q 128) and
    mamba2's training shape (B 4, S 4,096: 16 chunks), each in float32
    and bfloat16, with x, Bm and Cm strided slices of one
    conv output as ``ssd_block`` passes them.  y within 3e-4 (float32) /
    4e-2 (bfloat16), the reference's kernel tolerances; the final state,
    float32 in both, within 3e-4.  Returns the serving-shape cases'
    inputs and largest errors, keyed by shape and dtype."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR
    cases = (("serve", 1, 1024, 48, 64, 128, 256),
             ("partial_S1000", 1, 1000, 48, 64, 128, 256),
             ("B2", 2, 1024, 48, 64, 128, 256),
             ("sweep", 2, 512, 8, 64, 128, 128),
             ("train", 4, 4096, 48, 64, 128, 256))
    measured = {}
    for name, B, S, H, P, N, Q in cases:
        for dtype, tol in (("float32", 3e-4), ("bfloat16", 4e-2)):
            args = SR.sample_inputs(B, S, H, P, N, S + B, dev,
                                    getattr(torch, dtype))
            y, st = SK.ssd_scan_cuda(*args, Q)
            y0, st0 = SR.ssd_scan_ref(*args, Q)
            torch.cuda.synchronize()
            err_y = float((y.float() - y0.float()).abs().max())
            err_s = float((st - st0).abs().max())
            ok = bool(torch.allclose(y.float(), y0.float(), rtol=tol,
                                     atol=tol)
                      and torch.allclose(st, st0, rtol=3e-4, atol=3e-4))
            emit({"phase": "kernel_vs_plain", "kernel": "ssd_scan",
                  "case": f"{name}_{dtype}", "shape": [B, S, H, P, N],
                  "chunk": Q, "max_abs_err_y": err_y,
                  "max_abs_err_state": err_s,
                  "tolerance": {"y": tol, "state": 3e-4}, "ok": ok})
            if not ok:
                fail(f"ssd_scan differs from its plain version: {name} "
                     f"{dtype}, max err y {err_y}, state {err_s}")
            if name == "serve":
                measured[(B, S, H, P, N, Q, dtype)] = (args,
                                                       max(err_y, err_s))
    return measured


def _expected_launches(cfg, rep):
    """Every kernel's launches on a serving run: decode_attention once
    per attention layer (and once more per decoder layer's
    cross-attention) per decode step, moe_route once per MoE layer per
    prefill or decode step, ssd_scan once per SSD layer per prefill
    (decode runs the one-token recurrence), market_clear never."""
    plan = cfg.layer_plan()
    n_attn = sum(spec.kind == "attn" for spec in plan)
    n_cross = cfg.num_layers if cfg.enc_dec else 0
    n_ssm = sum(spec.kind == "ssm" for spec in plan)
    n_moe = sum(spec.moe for spec in plan)
    return {"market_clear": 0,
            "decode_attention": (n_attn + n_cross) * rep.decode_steps,
            "moe_route": n_moe * (rep.prefills + rep.decode_steps),
            "ssd_scan": n_ssm * rep.prefills, "ssd_scan_backward": 0}


def phase_reduced_server(dev, arch, prompt_len):
    """A reduced server (float32) on the card against the same run on
    the CPU: the same tokens; the last logits within 1e-4 (the same
    float32 formulas, summed in another order on each device)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import init_params
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shape = dict(requests=3, prompt_len=prompt_len, max_new=4, slots=2)
    _reset_launches()
    gpu = serve(arch, cfg=cfg, params=_to(params, dev), device=dev, **shape)
    launches = _read_launches()
    cpu = serve(arch, cfg=cfg, params=params, device="cpu", **shape)
    same = [r.out for r in gpu.requests] == [r.out for r in cpu.requests]
    lg, lc = gpu.server.last_logits.cpu(), cpu.server.last_logits
    err = float((lg - lc).abs().max())
    close = bool(torch.allclose(lg, lc, rtol=1e-4, atol=1e-4))
    want = _expected_launches(cfg, gpu)
    counted = launches == want
    emit({"phase": "reduced_server_gpu_vs_cpu", "arch": cfg.name,
          "reduced": True, **shape, "tokens_equal": bool(same),
          "tokens": [r.out for r in gpu.requests],
          "logits_max_abs_err": err, "tolerance": 1e-4,
          "launches": launches, "expected_launches": want})
    if not (same and close and counted):
        fail(f"reduced server on the card differs from the CPU run: tokens "
             f"equal {same}, logits err {err}, launches {launches} "
             f"(expected {want})")


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, d) for v in tree]
    return tree.to(d, copy=True)


def _frontend_batch(cfg, B, S, seed, dev):
    """Seeded tokens and the frontend's seeded embeddings (vision: the
    patches, audio: the frames; ``num_prefix_tokens`` of them)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    emb = rng.standard_normal((B, cfg.num_prefix_tokens, cfg.d_model))
    key = "prefix_embeds" if cfg.frontend == "vision_stub" \
        else "encoder_embeds"
    return {"tokens": torch.from_numpy(toks).to(dev),
            key: torch.from_numpy(emb.astype(np.float32)).to(dev)}


def _prefill_decode(params, cfg, batch, steps):
    """Prefill, then ``steps`` greedy decode steps, as
    tests/test_models.py ``test_arch_prefill_decode`` drives a frontend
    model.  Returns (tokens (B, steps + 1), last logits, cache, prefill
    s, decode s per step), each time ending in a synchronise."""
    import torch
    from repro_torch.models import model as M
    dev = batch["tokens"].device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    B, S = batch["tokens"].shape
    P = cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0
    sync()
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, cfg, batch, max_len=P + S + steps)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    sync()
    prefill_s = time.perf_counter() - t0
    out, step_s = [tok], []
    for t in range(steps):
        t0 = time.perf_counter()
        logits, cache = M.decode_step(params, cfg, cache, tok, P + S + t)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out.append(tok)
        sync()
        step_s.append(time.perf_counter() - t0)
    return torch.cat(out, 1), logits, cache, prefill_s, step_s


def phase_reduced_prefill_decode(dev, arch):
    """A reduced frontend model (float32) through prefill and 8 decode
    steps on the card against the same run on the CPU: the same tokens,
    the last logits within 1e-4, decode_attention once per self- and
    cross-attention layer per step."""
    import torch
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    steps = FRONTEND_FULL["steps"]
    batch = _frontend_batch(cfg, 2, 20, 5, "cpu")
    _reset_launches()
    gtok, glog, *_ = _prefill_decode(_to(params, dev), cfg,
                                     _to(batch, dev), steps)
    launches = _read_launches()
    ctok, clog, *_ = _prefill_decode(params, cfg, batch, steps)
    same = bool(torch.equal(gtok.cpu(), ctok))
    err = float((glog.cpu() - clog).abs().max())
    close = bool(torch.allclose(glog.cpu(), clog, rtol=1e-4, atol=1e-4))
    want = _expected_launches(cfg, SimpleNamespace(prefills=1,
                                                   decode_steps=steps))
    emit({"phase": "reduced_prefill_decode_gpu_vs_cpu", "arch": cfg.name,
          "reduced": True, "batch": 2, "text_tokens": 20, "steps": steps,
          "tokens_equal": same, "tokens": gtok.cpu().tolist(),
          "logits_max_abs_err": err, "tolerance": 1e-4,
          "launches": launches, "expected_launches": want})
    if not (same and close and launches == want):
        fail(f"reduced {cfg.name} prefill/decode on the card differs from "
             f"the CPU run: tokens equal {same}, logits err {err}, "
             f"launches {launches} (expected {want})")


def phase_decode_shapes_vs_plain(dev):
    """decode_attention against its plain version at every new model
    path's shape (``DECODE_SHAPES``): gemma3's windowed and global
    layers, qwen3, danube's head dim 80 under its 4,096 window,
    paligemma's MQA at head dim 256, whisper's self- and cross-attention
    (every key valid: pos Sk - 1, no window)."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    for path, B, S, K, G, hd, cases in DECODE_SHAPES:
        for dtype, tol in (("float32", 2e-5), ("bfloat16", 3e-2)):
            dt = getattr(torch, dtype)
            q = _randn((B, K, G, hd), 11, dev, dt)
            k = _randn((B, S, K, hd), 12, dev, dt)
            v = _randn((B, S, K, hd), 13, dev, dt)
            for pos, window in cases:
                got = DK.decode_attention_cuda(q, k, v, pos, window)
                want = DR.decode_attention_ref(q, k, v, pos, window)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                ok = bool(torch.allclose(got.float(), want.float(),
                                         rtol=tol, atol=tol))
                lo, hi, _ = DK.valid_range(S, pos, window)
                emit({"phase": "kernel_vs_plain",
                      "kernel": "decode_attention",
                      "case": f"{path}_{dtype}_pos{pos}_win{window}",
                      "shape": [B, S, K, G, hd], "valid": [lo, hi],
                      "max_abs_err": err, "tolerance": tol, "ok": ok})
                if not ok:
                    fail(f"decode_attention differs from its plain version "
                         f"at {path} {dtype} pos {pos} window {window}: "
                         f"max err {err}")
            del q, k, v


def phase_decode_cut(dev):
    """The partial mode on the ``DECODE_CUT`` caches cut into
    ``DECODE_CUT_RANKS`` blocks, merged and held against the whole-cache
    kernel and the plain version; then the timings at 4 blocks of
    gemma3's global layer.  Returns the ``partial`` entry of the
    ``kernels`` line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.decode_attention import ref as DR
    tol, launches, worst = BF16_MERGE_TOL, 0, 0.0
    timed = None
    for path, B, S, K, G, hd, cases in DECODE_CUT:
        dt = torch.bfloat16
        q = _randn((B, K, G, hd), 31, dev, dt)
        k = _randn((B, S, K, hd), 32, dev, dt)
        v = _randn((B, S, K, hd), 33, dev, dt)
        for pos, window in cases:
            whole = DK.decode_attention_cuda(q, k, v, pos, window)
            plain = DR.decode_attention_ref(q, k, v, pos, window)
            for R in DECODE_CUT_RANKS:
                n = S // R
                blocks = [(k[:, r * n:(r + 1) * n].contiguous(),
                           v[:, r * n:(r + 1) * n].contiguous())
                          for r in range(R)]
                DK.LAUNCHES = 0
                parts = [DO.partial(q, kb, vb, pos, window, r * n)
                         for r, (kb, vb) in enumerate(blocks)]
                got = DR.merge_partials(*(torch.stack(x) for x in
                                          zip(*parts)), dtype=dt)
                torch.cuda.synchronize()
                n_launch = DK.LAUNCHES
                launches += n_launch
                t = torch.arange(S, device=dev)
                valid = (t <= pos) & ((t > pos - window) if window else True)
                kinds, masked_ok, block_ok = [], True, True
                block_err = dict.fromkeys("oml", 0.0)
                for r, ((kb, vb), part) in enumerate(zip(blocks, parts)):
                    vr = valid[r * n:(r + 1) * n]
                    kind = ("full" if bool(vr.all()) else "part"
                            if bool(vr.any()) else "none")
                    kinds.append(kind)
                    if kind == "none":
                        masked_ok &= bool((part[1] == DR.NEG_INF).all()) \
                            and bool((part[2] == n).all())
                    # each block's (o, m, l) against the plain partial
                    for x, g, w in zip("oml", part,
                                       DR.decode_attention_partial_ref(
                                           q, kb, vb, pos, window, r * n)):
                        block_err[x] = max(block_err[x], float(
                            (g - w).abs().max()))
                        block_ok &= bool(torch.allclose(
                            g, w, rtol=PARTIAL_TOL, atol=PARTIAL_TOL))
                errs = [float((got.float() - w.float()).abs().max())
                        for w in (whole, plain)]
                ok = masked_ok and block_ok and n_launch == R and all(
                    bool(torch.allclose(got.float(), w.float(),
                                        rtol=BF16_STEP, atol=tol))
                    for w in (whole, plain))
                worst = max(worst, errs[1])
                emit({"phase": "decode_cut", "case": f"{path}_pos{pos}"
                      f"_win{window}_R{R}", "shape": [B, S, K, G, hd],
                      "blocks": kinds, "launches": n_launch,
                      "max_abs_err_blocks": block_err,
                      "tolerance_blocks": {"rtol": PARTIAL_TOL,
                                           "atol": PARTIAL_TOL},
                      "max_abs_err_vs_kernel": errs[0],
                      "max_abs_err_vs_plain": errs[1],
                      "max_abs_out": float(plain.float().abs().max()),
                      "tolerance": {"atol": tol, "rtol": BF16_STEP},
                      "ok": ok})
                if not ok:
                    fail(f"decode_cut {path} pos {pos} window {window} R {R}"
                         f": errors {errs}, block errors {block_err}, "
                         f"launches {n_launch}, blocks {kinds}, masked "
                         f"blocks reported right {masked_ok}")
                if path == "gemma3_global" and pos == 20000 and R == 4:
                    timed = (q, k, v, blocks[0], [torch.stack(x) for x in
                                                  zip(*parts)], pos)
                del blocks, parts
        del q, k, v
    q, k, v, (kb, vb), (o4, m4, l4), pos = timed
    B, S, K, hd = k.shape
    G, n = q.shape[2], kb.shape[1]
    lo, hi, _ = DK.valid_range(S, pos, 0)

    def sdpa(i):
        return F.scaled_dot_product_attention(
            q.reshape(B, K * G, 1, hd), k[:, lo:hi + 1].transpose(1, 2),
            v[:, lo:hi + 1].transpose(1, 2), enable_gqa=True)
    nbytes = 2 * (B * K * G * hd + 2 * B * n * K * hd) \
        + 4 * (B * K * G * hd + 2 * B * K * G)
    ops = 4 * B * K * G * n * hd
    bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
    entry = {"name": "decode_attention (partial mode)", "route": "cuda",
             "source": "src/repro_torch/csrc/decode_attention.cu",
             "replaces": "src/repro/kernels/decode_attention/kernel.py:78",
             "launches": launches, "max_abs_err": worst,
             "ms": _graph_ms(lambda i: DK.decode_attention_partial_cuda(
                 q, kb, vb, pos, 0, 0), 160),
             "ms_eager": _time_ms(lambda i: DK.decode_attention_partial_cuda(
                 q, kb, vb, pos, 0, 0), 160),
             "plain_ms": _graph_ms(lambda i: DR.decode_attention_partial_ref(
                 q, kb, vb, pos, 0, 0), 32),
             "bound_ms": bound_ms, "bound_by": bound_by,
             **_block_library(q, kb, vb, o4[0], m4[0], l4[0]),
             "merge_ms": _graph_ms(lambda i: DR.merge_partials(
                 o4, m4, l4, dtype=q.dtype), 160),
             "whole_ms": _graph_ms(lambda i: DK.decode_attention_cuda(
                 q, k, v, pos, 0), 160),
             "sdpa_whole_ms": _graph_ms(sdpa, 160),
             "bound_ms_whole": _bound(
                 2 * (2 * B * K * G * hd + 2 * B * (hi - lo + 1) * K * hd),
                 4 * B * K * G * (hi - lo + 1) * hd, BF16_OPS_PER_S)[0],
             "timed_shape": {"B": B, "S": S, "K": K, "G": G, "hd": hd,
                             "blocks": 4, "block": n, "pos": pos,
                             "block_offset": 0, "dtype": "bfloat16"},
             "bytes": nbytes, "operations": ops}
    emit({"phase": "decode_cut_times", **{k_: v_ for k_, v_ in entry.items()
                                          if k_ not in ("name", "source")}})
    return entry


def _block_library(q, kb, vb, o, m, l):
    """``library_ms`` for the partial mode: one PyTorch call that gives a
    fully valid block's normalised output and its logsumexp (``m +
    log l``, all ``merge_partials`` needs), the G query rows of a kv head
    as its query length; flash attention, else the memory-efficient
    one.  Its differences from the kernel's (o, m, l) on the same block
    are recorded beside it."""
    import torch
    qh, kh, vh = q, kb.transpose(1, 2), vb.transpose(1, 2)
    calls = (("aten._scaled_dot_product_flash_attention",
              lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                  qh, kh, vh, 0.0, False, False)[:2]),
             ("aten._scaled_dot_product_efficient_attention",
              lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                  qh, kh, vh, None, True)[:2]))
    errors = []
    for name, call in calls:
        try:
            out, lse = call()
            ms = _graph_ms(lambda i: call(), 160)
        except RuntimeError as e:                 # no such kernel here
            errors.append(f"{name}: {str(e)[:200]}")
            continue
        lse = lse[..., :q.shape[2]].float()
        return {"library_ms": ms, "library": name,
                "library_max_abs_err": {
                    "o": float((out.float() - o).abs().max()),
                    "lse": float((lse - (m + torch.log(l))).abs().max())}}
    return {"library_ms": None, "library": "; ".join(errors)}


# ------------------------------------------------------------------ phase 3
def _fleet_run(dev, run):
    """``run()`` with every launch count set to 0 just before and read
    just after; returns its result, wall seconds and launches."""
    import torch
    _reset_launches()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, _read_launches()


def _check_clear_launches(what, launches, waves):
    """The clearing kernel once per cascade wave and no other kernel."""
    others = {k: v for k, v in launches.items() if k != "market_clear"}
    if launches["market_clear"] != waves or any(others.values()):
        fail(f"{what} launched {launches} for {waves} cascade waves")


def _epoch_ms(res):
    import numpy as np
    ep = np.asarray(res.epoch_s[1:]) * 1e3
    return {"epoch_ms_p50": float(np.percentile(ep, 50)),
            "epoch_ms_p95": float(np.percentile(ep, 95)),
            "epoch_ms_first": float(res.epoch_s[0] * 1e3)}


def phase_main_path(dev):
    import numpy as np
    import torch
    from repro_torch.sim.simulator import FLEET_10K, FleetScenarioConfig, \
        run_fleet_scenario
    cfg = FleetScenarioConfig(**FLEET_10K)
    res, total, launches = _fleet_run(
        dev, lambda: run_fleet_scenario(cfg, device=dev))
    est = res.engine_state
    waves, resorts = int(est["waves"]), int(est["resorts"])
    perf = res.perf
    finite = bool(np.isfinite(perf).all()
                  and np.isfinite(res.alone_perf).all()
                  and torch.isfinite(est["rate"]).all()
                  and torch.isfinite(est["bills"]).all())
    orders, transfers = res.stats["orders"], res.stats["transfers"]
    retention = f"{res.mean_retention:.3f}"
    matches = (orders == COMMITTED_10K["orders"]
               and transfers == COMMITTED_10K["transfers"]
               and len(res.epoch_s) == COMMITTED_10K["epochs"]
               and retention == COMMITTED_10K["mean_retention"])
    alone_runs = 3 * cfg.alone_sample        # three kinds
    emit({"phase": "main_path", "config": FLEET_10K,
          "epochs": len(res.epoch_s), "orders": orders,
          "transfers": transfers, "mean_retention": res.mean_retention,
          "committed": COMMITTED_10K,
          "matches_committed": bool(matches), "waves": waves,
          "alone_runs": len(res.alone_waves),
          "alone_waves": res.alone_waves, "resorts": resorts,
          "launches": launches, "stats": res.stats,
          "mean_perf": float(np.mean(perf[np.isfinite(perf)])),
          **_epoch_ms(res),
          "epoch_ms_all": [float(x * 1e3) for x in res.epoch_s],
          "wall_s": total - res.alone_s, "alone_s": res.alone_s,
          "finite": finite})
    if not finite:
        fail("main path produced non-finite perf, denominators, rates or "
             "bills")
    if len(res.alone_waves) != alone_runs:
        fail(f"the denominator made {len(res.alone_waves)} alone runs; "
             f"expected {alone_runs}")
    if waves <= 0:
        fail("the main path ran no cascade wave")
    _check_clear_launches("the main path (drive and alone runs)",
                          launches, waves + sum(res.alone_waves))
    if not matches:
        fail(f"10k run gave orders={orders} transfers={transfers} "
             f"retention={retention} over {len(res.epoch_s)} epochs; "
             f"committed {COMMITTED_10K}")
    return res, launches


# ------------------------------------------------------------ phase 3a
STATE_CHECK_REPS = 5


@contextlib.contextmanager
def _hook_sites():
    """Count, while open, the calls of the four sites that publish a
    state through ``schema.maybe_validate``: ``EpochRunner.drive``,
    ``CrashSafeRunner._publish``, ``BatchMarket._step`` and
    ``BatchMarket.step_arrays``."""
    from repro_torch.market_torch.bridge import BatchMarket
    from repro_torch.sim.epoch import EpochRunner
    from repro_torch.sim.recovery import CrashSafeRunner
    counts = {"drive": 0, "_publish": 0, "_step": 0, "step_arrays": 0}
    saved = {(cls, name): getattr(cls, name) for cls, name in (
        (EpochRunner, "drive"), (CrashSafeRunner, "_publish"),
        (BatchMarket, "_step"), (BatchMarket, "step_arrays"))}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapper
    try:
        for (cls, name), fn in saved.items():
            setattr(cls, name, counted(name, fn))
        yield counts
    finally:
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)


def _validate_profile(schema, est, eng):
    """Kernel launches and copies of one ``validate_state``, from
    ``torch.profiler``: ``memcpy`` counts the device's copy records by
    direction (``DtoH``: reads to the host)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        schema.validate_state(est, eng)
    launches, copies = 0, {}
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                     "cudaLaunchKernelExC"):
            launches += e.count
        if e.key.startswith("Memcpy "):
            way = e.key.split()[1]
            copies[way] = copies.get(way, 0) + e.count
    return launches, copies


def _hooked_paths(dev, schema, root):
    """``LAISSEZ_VALIDATE=1`` through the three hooked paths on the card:
    the 256-leaf fleet through ``EpochRunner``, a ``CrashSafeRunner`` run
    and one resume, and a facade's Market-API steps and ``step_arrays``.
    Returns the site counts and the states the hook validated."""
    import os
    import torch
    from repro_torch.core.market import Market
    from repro_torch.core.topology import build_cluster
    from repro_torch.market_torch.bridge import BatchMarket
    from repro_torch.sim.simulator import FleetScenarioConfig, \
        run_fleet_scenario
    from repro_torch.sim.traces import apply_event, market_trace
    cfg = FleetScenarioConfig(**SMALL_FLEET)
    before = schema.VALIDATED
    old = os.environ.get(schema.VALIDATE_ENV)
    os.environ[schema.VALIDATE_ENV] = "1"
    try:
        with _hook_sites() as sites:
            run_fleet_scenario(cfg, device=dev)
            runner, _, _, params = _durable_fleet(cfg, dev, root, [],
                                                  snapshot_every=5)
            runner.run(params, cfg.duration_s, cfg.tick_s)
            runner, _, _, params = _durable_fleet(cfg, dev, root, [],
                                                  snapshot_every=5)
            runner.resume(params, cfg.duration_s, cfg.tick_s)
            topo = build_cluster({"H100": 16}, gpus_per_host=4,
                                 hosts_per_rack=2, racks_per_zone=2)
            bm = BatchMarket(topo, capacity=1 << 8, n_tenants=8,
                             device=dev)
            for e in market_trace(Market(topo), 0, 40):
                apply_event(bm, e)
            bids = {"price": torch.tensor([9.0, 8.0], device=dev),
                    "limit": torch.tensor([12.0, 12.0], device=dev),
                    "level": torch.tensor([4, 0], dtype=torch.int32,
                                          device=dev),
                    "node": torch.tensor([0, 3], dtype=torch.int32,
                                         device=dev),
                    "tenant": torch.tensor([1, 2], dtype=torch.int32,
                                           device=dev)}
            for i in range(3):
                bm.step_arrays("H100", bm.now + 60.0 * (i + 1), bids)
            torch.cuda.synchronize()
    finally:
        if old is None:
            os.environ.pop(schema.VALIDATE_ENV, None)
        else:
            os.environ[schema.VALIDATE_ENV] = old
    return dict(sites), schema.VALIDATED - before


def _break_cases(dev, schema):
    """Every case of ``tests/torch_schema_cases.py`` on a card copy of
    its clean state: each must raise its error, with the message the
    same case gives on the CPU."""
    import torch
    sys.path.insert(0, str(HERE / "tests"))
    import torch_schema_cases as C
    from repro_torch.convert import to_numpy
    from repro_torch.market_torch.engine import BatchEngine, build_tree

    def engine(d):
        return BatchEngine(build_tree(64), capacity=256, n_tenants=12, k=4,
                           device=d)
    eng, cpu_eng = engine(dev), engine("cpu")
    clean, cpu_clean = C.clean_state(eng), C.clean_state(cpu_eng)
    diff = _differing_keys(to_numpy(cpu_clean), to_numpy(clean))
    if diff:
        fail(f"the checker's clean state differs on the card: {diff}")
    schema.validate_state(clean, eng)

    def raised(state, e):
        try:
            schema.validate_state(state, e)
        except (AssertionError, schema.StateInvariantError) as err:
            return type(err).__name__, str(err)
        return None, None
    caught, bad = [], []
    for case in C.CASES:
        st = C.broken(clean, eng, case)
        on_card = all(v.is_cuda for v in st.values()
                      if isinstance(v, torch.Tensor))
        kind, msg = raised(st, eng)
        cpu = raised(C.broken(cpu_clean, cpu_eng, case), cpu_eng)
        want = ("StateInvariantError" if case.kind == "runtime"
                else "AssertionError")
        if kind == want and case.expect in msg and (kind, msg) == cpu \
                and on_card:
            caught.append(case.name)
        else:
            bad.append({"case": case.name, "raised": kind, "message": msg,
                        "cpu": cpu[1], "on_card": on_card})
    return len(C.CASES), caught, bad


def _traced_epochs(dev, schema):
    """Two epochs of the 256-leaf fleet on the card through
    ``schema.trace_epoch``: the keys each traced function wrote
    (``trace_effects`` raises on an undeclared one)."""
    import torch
    from repro_torch.sim.epoch import EpochRunner
    from repro_torch.sim.simulator import FleetScenarioConfig, \
        _seed_floors, make_fleet
    cfg = FleetScenarioConfig(**SMALL_FLEET)
    topo, _, market, fleet, params = make_fleet(cfg, dev)
    _seed_floors(market, topo)
    runner = EpochRunner(market, fleet, "H100")
    est = dict(market.states["H100"])
    est["floor"], est["floor_t"] = tuple(est["floor"]), tuple(est["floor_t"])
    stats = {k: torch.zeros((), dtype=torch.int32, device=dev)
             for k in schema.STAT_KEYS}
    fst, record = fleet.init_state(params), []
    for t in (0.0, cfg.tick_s):
        est, fst, stats = schema.trace_epoch(runner, params, est, fst, stats,
                                             t, where=f"H100 epoch t={t}",
                                             record=record)
    torch.cuda.synchronize()
    seen = {}
    for qualname, keys in record:
        seen.setdefault(qualname, set()).update(keys)
    return {q: sorted(k) for q, k in seen.items()}, len(record)


def phase_state_checker(dev, card, fleet_res):
    """The port's state checker on the card: ``validate_state`` on the
    final 10k fleet state of phase 3 (ms, median of
    ``STATE_CHECK_REPS``, host clock, ending in its one host read), the
    hooked paths under ``LAISSEZ_VALIDATE=1`` (one validation per
    publish or step, none raising), and every break case caught."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.market_torch import schema
    from repro_torch.sim.simulator import FLEET_10K, FleetScenarioConfig, \
        make_fleet
    est = fleet_res.engine_state
    eng = make_fleet(FleetScenarioConfig(**FLEET_10K), dev)[2] \
        .engines["H100"]
    schema.validate_state(est, eng)                  # warm-up, and clean
    ms = []
    for _ in range(STATE_CHECK_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        schema.validate_state(est, eng)
        ms.append((time.perf_counter() - t0) * 1e3)
    launches, copies = _validate_profile(schema, est, eng)
    t0 = time.perf_counter()
    root = OUT / "state_checker_work"
    shutil.rmtree(root, ignore_errors=True)
    try:
        sites, validated = _hooked_paths(dev, schema, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t1 = time.perf_counter()
    total, caught, bad = _break_cases(dev, schema)
    t2 = time.perf_counter()
    try:
        effects, traced = _traced_epochs(dev, schema)
    except AssertionError as err:
        fail(f"trace_effects on the card: {err}")
    emit({"phase": "state_checker", "card": card,
          "n_leaves": FLEET_10K["n_leaves"],
          "capacity": eng.capacity, "n_tenants": eng.n_tenants,
          "predicates": len(schema._runtime_checks(eng, est)),
          "validate_ms_10k": float(np.median(ms)), "validate_ms_all": ms,
          "kernel_launches": launches, "memcpy": copies,
          "hook_sites": sites, "hook_validations": validated,
          "hooked_paths_s": t1 - t0, "break_cases": total,
          "caught": len(caught), "not_caught": bad,
          "break_cases_s": t2 - t1, "traced_calls": traced,
          "observed_writes": effects,
          "trace_effects_s": time.perf_counter() - t2})
    for qualname, keys in effects.items():
        if not set(keys) <= set(schema.EFFECTS[qualname]["writes"]):
            fail(f"{qualname} wrote undeclared keys on the card")
    if validated != sum(sites.values()) or not all(sites.values()):
        fail(f"LAISSEZ_VALIDATE=1 validated {validated} states at sites "
             f"{sites}: one per publish or step expected")
    if bad or len(caught) != total:
        fail(f"the state checker missed break cases on the card: {bad}")


def degradation_reduction(base_ret: float, lc_ret: float) -> float:
    """The paper's percent reduction in degradation ``1 - retention``
    from a baseline to laissez (``benchmarks/fig06_contention.py``):
    retentions clamped into [0, 1]; a baseline at full retention leaves
    nothing to reduce (0, or -100 when laissez falls short of it)."""
    b = min(max(base_ret, 0.0), 1.0)
    lc = min(max(lc_ret, 0.0), 1.0)
    if 1.0 - b <= 1e-9:
        return 0.0 if 1.0 - lc <= 1e-9 else -100.0
    return ((1 - b) - (1 - lc)) / (1 - b) * 100.0


def phase_fig06_scale(dev, laissez_10k):
    """Fig 6 at fleet scale: the three baselines at n=10,000 on phase 3's
    cached denominator (no alone run repeats), then the n=2,048 case
    with the analytic denominator; every row held to its committed
    value, the baselines launching no kernel."""
    from repro_torch.sim.fleet_baselines import BASELINES, \
        run_fleet_baseline
    from repro_torch.sim.simulator import FLEET_10K, FleetScenarioConfig, \
        run_fleet_scenario
    for n, conf in ((10000, FLEET_10K), (2048, FLEET_2048)):
        cfg = FleetScenarioConfig(**conf)
        if n == 10000:
            laissez = laissez_10k
        else:
            laissez, wall, launches = _fleet_run(
                dev, lambda: run_fleet_scenario(cfg, device=dev))
            waves = int(laissez.engine_state["waves"])
            got = {"orders": laissez.stats["orders"],
                   "transfers": laissez.stats["transfers"],
                   "epochs": len(laissez.epoch_s),
                   "mean_retention": f"{laissez.mean_retention:.3f}"}
            emit({"phase": "fig06_scale", "n": n, "cloud": "laissez",
                  "config": conf, **got,
                  "mean_retention_exact": laissez.mean_retention,
                  "committed": COMMITTED_2048, "waves": waves,
                  "launches": launches, **_epoch_ms(laissez),
                  "wall_s": wall})
            _check_clear_launches(f"laissez at n={n}", launches, waves)
            if got != COMMITTED_2048:
                fail(f"laissez at n={n} gave {got}; committed "
                     f"{COMMITTED_2048}")
        reductions = {}
        for kind in BASELINES:
            res, wall, launches = _fleet_run(
                dev, lambda: run_fleet_baseline(kind, cfg, device=dev))
            got = (f"{res.mean_retention:.3f}", int(res.stats["grants"]),
                   int(res.stats["preemptions"]))
            want = COMMITTED_BASELINES[n][kind]
            emit({"phase": "fig06_scale", "n": n, "cloud": kind,
                  "mean_retention": res.mean_retention,
                  "grants": got[1], "preemptions": got[2],
                  "committed": want, "stats": res.stats,
                  "alone_runs": len(res.alone_waves),
                  "launches": launches, "wall_s": wall,
                  "alone_s": res.alone_s})
            if n == 10000 and res.alone_waves:
                fail(f"{kind} at n={n} recomputed the denominator phase 3 "
                     "cached")
            _check_clear_launches(f"the {kind} baseline at n={n}",
                                  launches, sum(res.alone_waves))
            if got != want:
                fail(f"{kind} at n={n} gave (retention, grants, "
                     f"preemptions) {got}; committed {want}")
            red = degradation_reduction(res.mean_retention,
                                        laissez.mean_retention)
            reductions[kind] = f"{red:.1f}%"
        emit({"phase": "fig06_scale", "n": n,
              "degradation_reduction_vs": reductions,
              "committed": COMMITTED_REDUCTION[n]})
        if reductions != COMMITTED_REDUCTION[n]:
            fail(f"degradation reductions at n={n}: {reductions}; "
                 f"committed {COMMITTED_REDUCTION[n]}")


def _storm_health(events, n_leaves, t, dev):
    """The health the storm's events due by ``t`` leave on a fresh tree,
    with two racks draining on top."""
    import torch
    from repro_torch.market_torch.engine import BatchEngine, build_tree
    from repro_torch.sim.faults import FaultInjector, LEVEL_RACK, \
        drain_schedule
    eng = BatchEngine(build_tree(n_leaves), capacity=8, device=dev)
    st = {"health": torch.zeros(n_leaves, dtype=torch.int32, device=dev)}
    st = FaultInjector(events).apply_health(eng, st, t)
    drains = drain_schedule([(LEVEL_RACK, 11), (LEVEL_RACK, 200)], 0.0)
    return FaultInjector(drains).apply_health(eng, st, 0.0)["health"]


def phase_faults(dev):
    """The ``BENCH_fig_faults.json`` n=10,000 pair, the storm run against
    the CPU, then the clearing kernel against its plain version on the
    storm's final book."""
    import numpy as np
    import torch
    from repro_torch.convert import to_numpy
    from repro_torch.market_torch.engine import HEALTH_DOWN, \
        HEALTH_DRAINING, build_tree
    from repro_torch.sim.faults import rack_failure_storm, \
        zone_supply_shock
    from repro_torch.sim.simulator import FleetScenarioConfig, \
        run_fleet_scenario
    n, dur = FAULTS_10K["n_leaves"], FAULTS_10K["duration_s"]
    storm = (rack_failure_storm(build_tree(n), 120.0, dur * 0.6, 180.0,
                                240.0, racks_per_burst=2, seed=7)
             + zone_supply_shock(dur * 0.3, dur * 0.7, zone=0))
    res = cfg = None
    epoch_ms = {}
    for tag, faults in (("nofault", None), ("storm", storm)):
        cfg = FleetScenarioConfig(**FAULTS_10K, faults=faults)
        res, wall, launches = _fleet_run(
            dev, lambda: run_fleet_scenario(cfg, device=dev))
        epoch_ms[tag] = _epoch_ms(res)
        waves = int(res.engine_state["waves"])
        got = {"revoked_by_fault": res.stats["revoked_by_fault"],
               "epochs": len(res.epoch_s)}
        emit({"phase": "faults", "case": tag, "n": n,
              "fault_events": len(faults or ()), **got,
              "transfers": res.stats["transfers"],
              "mean_retention": res.mean_retention,
              "orders": res.stats["orders"],
              "committed": COMMITTED_FAULTS[tag],
              "committed_stale": STALE_FAULT_ROWS[tag], "waves": waves,
              "launches": launches, **epoch_ms[tag], "wall_s": wall})
        _check_clear_launches(f"the {tag} run", launches, waves)
        if got != COMMITTED_FAULTS[tag]:
            fail(f"the {tag} run at n={n} gave {got}; committed "
                 f"{COMMITTED_FAULTS[tag]}")
    t0 = time.perf_counter()
    cpu = run_fleet_scenario(cfg, device="cpu")
    diff = _differing_keys(to_numpy(cpu.engine_state),
                           to_numpy(res.engine_state))
    identical = (not diff and np.array_equal(res.perf, cpu.perf)
                 and res.stats == cpu.stats)
    emit({"phase": "faults", "case": "storm_gpu_vs_cpu", "n": n,
          "identical": bool(identical), "differing_keys": diff,
          "cpu_stats": cpu.stats, "cpu_s": time.perf_counter() - t0})
    if not identical:
        fail(f"the storm run on the card differs from the CPU run: keys "
             f"{diff}, stats {res.stats} vs {cpu.stats}")
    names = ("rate", "best_level", "cand_slots", "truncated", "evict")
    k = FAULTS_10K["k"]
    _, aggs, args = _final_book(res.engine_state, n, k)
    for case, health in (
            ("storm_final_health", res.engine_state["health"]),
            ("storm_t480_health_2_racks_draining",
             _storm_health(storm, n, 480.0, dev))):
        plain, got = _clear_pair(aggs, args, k, health)
        equal = {nm: bool(torch.equal(a, b))
                 for nm, a, b in zip(names, plain, got)}
        emit({"phase": "kernel_vs_plain", "kernel": "market_clear",
              "case": case, "k": k, "n_leaves": n,
              "down": int((health == HEALTH_DOWN).sum()),
              "draining": int((health == HEALTH_DRAINING).sum()),
              "equal": equal,
              "max_abs_err": float((plain[0] - got[0]).abs().max()),
              "tolerance": 0.0})
        if not all(equal.values()):
            fail(f"market_clear differs from its plain version on the "
                 f"storm's final book ({case}): {equal}")
    return res, storm, epoch_ms["nofault"]["epoch_ms_p50"]


# ------------------------------------------------------------ phase 3d
# tests/test_recovery.py's chaos configuration (_fcfg at 64 leaves)
CHAOS_FLEET = dict(regime="heavy", n_leaves=64, n_training=3,
                   n_inference=3, n_batch=2, duration_s=600.0, tick_s=60.0,
                   seed=3, k=4, b_max=64, per_tenant_bids=4, alone="none")
SNAPSHOT_EVERY = 5               # benchmarks/fig_faults.py
RECOVERY_REPEATS = 3             # warm resumes after the cold one


def _run_fingerprint(market, fleet, params, fs, stats, dur):
    """What a recovered run must reproduce: the engine's owners, rates,
    bills and health, the fleet's performance and the run's stats."""
    from repro_torch.convert import to_numpy
    est = to_numpy(market.states["H100"])
    return ({k: est[k] for k in ("owner", "rate", "bills", "health")},
            fleet.performance(params, fs, dur).cpu().numpy(),
            {k: int(stats[k]) for k in stats})


def _fingerprint_diff(a, b):
    """Names of the parts where two run fingerprints differ."""
    import numpy as np
    diff = [k for k in a[0] if not np.array_equal(a[0][k], b[0][k])]
    if not np.array_equal(a[1], b[1]):
        diff.append("performance")
    if a[2] != b[2]:
        diff.append("stats")
    return diff


def _durable_fleet(cfg, dev, workdir, events, snapshot_every=1):
    """A fresh process of the durable fleet run: market, fleet and
    params rebuilt from ``cfg`` on ``dev``, a runner over ``workdir``."""
    from repro_torch.sim.faults import FaultInjector
    from repro_torch.sim.recovery import CrashSafeRunner
    from repro_torch.sim.simulator import _seed_floors, make_fleet
    topo, _, market, fleet, params = make_fleet(cfg, dev)
    _seed_floors(market, topo)
    runner = CrashSafeRunner(market, fleet, "H100", str(workdir),
                             snapshot_every=snapshot_every,
                             injector=FaultInjector(events))
    return runner, market, fleet, params


def _recovery_10k(dev, storm_res, storm, epoch_ms_p50, root):
    """``benchmarks/fig_faults.py`` ``_recovery_row`` on the card: the
    durable storm run killed at the final epoch's post_step, then one
    cold and three warm resumes from pristine copies of its workdir,
    each held to phase ``faults``' storm run."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.sim.epoch import STAT_KEYS
    from repro_torch.sim.faults import FaultEvent, FaultInjector
    from repro_torch.sim.recovery import CrashSafeRunner, SimulatedCrash, \
        _ticks
    from repro_torch.sim.simulator import FleetScenarioConfig
    cfg = FleetScenarioConfig(**FAULTS_10K)
    dur, tick = cfg.duration_s, cfg.tick_s
    ticks = _ticks(dur, tick)
    last = len(ticks) - 1
    replay = last % SNAPSHOT_EVERY or SNAPSHOT_EVERY
    pristine = root / "pristine"
    est = storm_res.engine_state
    want = ({k: est[k].cpu().numpy()
             for k in ("owner", "rate", "bills", "health")},
            storm_res.perf,
            {k: int(storm_res.stats[k]) for k in STAT_KEYS})
    kill = [FaultEvent(ticks[-1], "crash", phase="post_step")]
    _reset_launches()
    t0 = time.perf_counter()
    runner, market, fleet, params = _durable_fleet(
        cfg, dev, pristine, storm + kill, SNAPSHOT_EVERY)
    try:
        runner.run(params, dur, tick)
        fail("the scheduled crash of the durable 10k run did not fire")
    except SimulatedCrash:
        pass
    torch.cuda.synchronize()
    durable_s = time.perf_counter() - t0
    durable_launches = _read_launches()
    storm_waves = int(est["waves"])
    snaps = runner.ckpt.all_steps()
    snap = snaps[-1]
    snap_path = runner.ckpt._path(snap)
    with np.load(snap_path) as z:
        snap_waves = int(z["['eng']['waves']"])
    wal_bytes = (pristine / "bids.wal").stat().st_size
    times, checks = [], []
    for i in range(RECOVERY_REPEATS + 1):
        rep = root / f"rep{i}"
        shutil.copytree(pristine, rep)
        r2 = CrashSafeRunner(market, fleet, "H100", str(rep),
                             snapshot_every=SNAPSHOT_EVERY,
                             injector=FaultInjector(storm))
        _reset_launches()
        t1 = time.perf_counter()
        fs, stats = r2.resume(params, dur, tick)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        launches = _read_launches()
        got = _run_fingerprint(market, fleet, params, fs, stats, dur)
        waves = int(market.states["H100"]["waves"])
        checks.append({"diff": _fingerprint_diff(got, want),
                       "launches": launches,
                       "waves_replayed": waves - snap_waves,
                       "final_waves": waves})
        shutil.rmtree(rep, ignore_errors=True)
    # the snapshot's save: a blocking save of the resumed final state
    state = {"eng": r2._canon(market.states["H100"]), "fleet": fs,
             "stats": {k: torch.tensor(v, dtype=torch.int32, device=dev)
                       for k, v in stats.items()}}
    scratch = CheckpointManager(str(root / "save"), keep=1)
    save_ms = []
    for step in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scratch.save(step, state)
        save_ms.append((time.perf_counter() - t1) * 1e3)
    cold, warm = times[0], times[1:]
    p50 = float(np.median(warm))
    emit({"phase": "recovery", "case": "fig_faults_10k", "n": cfg.n_leaves,
          "snapshot_every": SNAPSHOT_EVERY, "snapshots": snaps,
          "replay_epochs": replay, "recovery_s_cold": cold,
          "recovery_s_p50": p50, "recovery_s_all": times,
          "nofault_epoch_ms_p50": epoch_ms_p50,
          "recovery_x_epoch_p50": p50 * 1e3 / epoch_ms_p50,
          "snapshot_bytes": snap_path.stat().st_size,
          "save_ms": save_ms, "wal_bytes": wal_bytes,
          "wal_bytes_per_epoch": wal_bytes / len(ticks),
          "durable_s": durable_s, "durable_launches": durable_launches,
          "storm_waves": storm_waves, "resumes": checks})
    if durable_launches["market_clear"] != storm_waves or \
            any(v for k, v in durable_launches.items()
                if k != "market_clear"):
        fail(f"the durable run launched {durable_launches}; the storm run "
             f"cleared {storm_waves} waves")
    for i, c in enumerate(checks):
        if c["diff"]:
            fail(f"resume {i} of the killed 10k run differs from the storm "
                 f"run in {c['diff']}")
        _check_clear_launches(f"resume {i}", c["launches"],
                              c["waves_replayed"])
        if c["final_waves"] != storm_waves or c["waves_replayed"] <= 0:
            fail(f"resume {i} ended at {c['final_waves']} waves; the storm "
                 f"run at {storm_waves}")


def _chaos_sweep(dev, root):
    """At the 64-leaf chaos configuration, kill at each of the five
    phases of a random epoch and at epoch 0, then resume; each result
    must equal the uninterrupted card run and the same run on the
    CPU."""
    import numpy as np
    from repro_torch.market_torch.engine import build_tree
    from repro_torch.sim.faults import FaultEvent, rack_failure_storm, \
        zone_supply_shock
    from repro_torch.sim.recovery import PHASES, SimulatedCrash, _ticks
    from repro_torch.sim.simulator import FleetScenarioConfig
    cfg = FleetScenarioConfig(**CHAOS_FLEET)
    dur, tick = cfg.duration_s, cfg.tick_s
    events = (rack_failure_storm(build_tree(64), 120.0, 400.0, 180.0,
                                 150.0, seed=9)
              + zone_supply_shock(240.0, 420.0, zone=0))
    base = {}
    for d in (dev, "cpu"):
        runner, market, fleet, params = _durable_fleet(
            cfg, d, root / f"base_{d}", events)
        fs, stats = runner.run(params, dur, tick)
        base[str(d)] = _run_fingerprint(market, fleet, params, fs, stats,
                                        dur)
    card, cpu = base[str(dev)], base["cpu"]
    ticks = _ticks(dur, tick)
    rng = np.random.default_rng(17)        # tests/test_recovery.py's
    kills = [(ticks[int(rng.integers(1, len(ticks)))], ph) for ph in PHASES]
    kills.append((0.0, "post_wal"))
    out = []
    for i, (kill_t, phase) in enumerate(kills):
        wd = root / f"kill{i}"
        runner, _, _, params = _durable_fleet(
            cfg, dev, wd, events + [FaultEvent(kill_t, "crash",
                                               phase=phase)])
        try:
            runner.run(params, dur, tick)
            fail(f"the chaos kill at {kill_t}/{phase} did not fire")
        except SimulatedCrash:
            pass
        runner, market, fleet, params = _durable_fleet(cfg, dev, wd, events)
        fs, stats = runner.resume(params, dur, tick)
        got = _run_fingerprint(market, fleet, params, fs, stats, dur)
        out.append({"kill_t": kill_t, "phase": phase,
                    "vs_card": _fingerprint_diff(got, card),
                    "vs_cpu": _fingerprint_diff(got, cpu)})
    card_vs_cpu = _fingerprint_diff(card, cpu)
    emit({"phase": "recovery", "case": "chaos_64", "kills": out,
          "card_vs_cpu": card_vs_cpu, "stats": card[2]})
    if card_vs_cpu or any(k["vs_card"] or k["vs_cpu"] for k in out):
        fail(f"the chaos sweep differs: card vs CPU {card_vs_cpu}, "
             f"kills {out}")


def phase_recovery(dev, storm_res, storm, epoch_ms_p50):
    """Crash-safe recovery on the card: the 10k storm run killed and
    resumed (held to phase ``faults``' storm run), then the 64-leaf
    chaos sweep (held to the uninterrupted card and CPU runs).  The
    durable files live in a scratch folder under ``OUT``, removed at
    the end."""
    import shutil
    root = OUT / "recovery_work"
    shutil.rmtree(root, ignore_errors=True)
    try:
        _recovery_10k(dev, storm_res, storm, epoch_ms_p50, root / "10k")
        _chaos_sweep(dev, root / "chaos")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ phase 3e
# benchmarks/fig06_contention.py PARITY_CFG (seed 1) and its committed
# fig06/parity/{regime}/laissez_batch rows (mean retention)
PARITY_CFG = dict(duration_s=1800.0, tick_s=90.0, n_training=1,
                  n_inference=1, n_batch=0, n_h100=4, n_a100=4, seed=1)
COMMITTED_PARITY = {"right_sized": "0.563", "slight": "0.657",
                    "heavy": "0.574"}


@contextlib.contextmanager
def _facade_counts():
    """Count, while open, the facade's Market-API calls (``events``)
    and the engine steps behind them (``steps``), and time the steps
    (``step_s``, each ending in a synchronise) and the host copies after
    them (``pull_s``), by wrapping the facade's and the engine's
    methods."""
    import torch
    from repro_torch.market_torch.bridge import BatchMarket
    from repro_torch.market_torch.engine import BatchEngine
    counts = {"events": 0, "steps": 0, "step_s": 0.0, "pull_s": 0.0}
    events = ("place_order", "cancel_order", "relinquish",
              "set_retention_limit", "set_floor", "advance_to")
    saved = {(cls, name): getattr(cls, name) for cls, name in
             [(BatchMarket, e) for e in events]
             + [(BatchMarket, "_step"), (BatchMarket, "_pull"),
                (BatchEngine, "step")]}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            if name in events:
                counts["events"] += 1
            if name == "_step":
                counts["steps"] += 1
            if name not in ("step", "_pull"):
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if name == "step":
                torch.cuda.synchronize()
            counts["step_s" if name == "step" else "pull_s"] += \
                time.perf_counter() - t0
            return out
        return wrapper
    try:
        for (cls, name), fn in saved.items():
            setattr(cls, name, counted(name, fn))
        yield counts
    finally:
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)


def _facade_replay(topo, events, dev):
    """The trace on a facade on ``dev``: after every event its owners,
    rates, settle bills, stats and the callbacks fired."""
    from repro_torch.market_torch.bridge import BatchMarket
    from repro_torch.sim.traces import apply_event
    bm = BatchMarket(topo, capacity=1 << 10, n_tenants=16, device=dev)
    calls = []
    bm.on_transfer.append(lambda *a: calls.append(a))
    leaves = [leaf for root in topo.roots.values()
              for leaf in topo.leaves_of(root)]
    out = []
    for e in events:
        apply_event(bm, e)
        out.append(([bm.owner_of(leaf) for leaf in leaves],
                    [bm.market_rate(leaf) for leaf in leaves], bm.settle(),
                    dict(bm.stats), list(calls)))
        calls.clear()
    return out, bm


def _clear_card_vs_cpu(eng, st, cpu_eng):
    """``clear`` and ``clear_topk`` of one state on the card and on the
    CPU: the names of the outputs that differ."""
    import torch
    from repro_torch.convert import to_numpy, to_torch
    cst = to_torch(to_numpy(st), "cpu")
    got = eng.clear(st) + eng.clear_topk(st)
    want = cpu_eng.clear(cst) + cpu_eng.clear_topk(cst)
    names = ("rate", "best_level", "winner", "topk_rate", "topk_level",
             "cands", "truncated")
    return [n for n, g, w in zip(names, got, want)
            if g.dtype != w.dtype or not torch.equal(g.cpu(), w)]


def phase_event_path(dev, storm_res):
    """The event-driven market path on the card: Fig 6's parity rows
    (``run_with_retention`` of ``laissez_batch``, every call one engine
    step behind the facade) held to the committed rows and to the event
    market, a differential trace on the card's and the CPU's facades,
    and ``clear`` / ``clear_topk`` on the card against the CPU."""
    import torch
    from repro_torch.core.market import Market
    from repro_torch.core.topology import build_cluster
    from repro_torch.market_torch.engine import BatchEngine, build_tree
    from repro_torch.sim.simulator import ScenarioConfig, \
        run_with_retention
    from repro_torch.sim.traces import market_trace
    t_phase = time.perf_counter()
    for regime, committed in COMMITTED_PARITY.items():
        cfg = ScenarioConfig(regime=regime, **PARITY_CFG)
        event = run_with_retention("laissez", cfg, device=dev)
        _reset_launches()
        t0 = time.perf_counter()
        with _facade_counts() as counts:
            batch = run_with_retention("laissez_batch", cfg, device=dev)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        events, steps = counts["events"], counts["steps"]
        step_ms = counts["step_s"] * 1e3 / max(steps, 1)
        pull_ms = counts["pull_s"] * 1e3 / max(steps, 1)
        b, e = batch.mean_retention, event.mean_retention
        got = f"{b:.3f}"
        minus = f"{b - e:+.3f}"
        emit({"phase": "event_path", "case": "fig06_parity",
              "regime": regime, "mean_retention": b, "committed": committed,
              "retention": batch.retention, "event_retention": e,
              "batch_minus_event": minus,
              "identical_to_event": batch.retention == event.retention,
              "runs": 1 + len(batch.perf), "facade_events": events,
              "steps": steps, "launches": launches, "wall_s": wall,
              "ms_per_event": wall * 1e3 / max(events, 1),
              "step_ms": step_ms, "pull_ms": pull_ms,
              "other_ms_per_event": (wall - counts["step_s"]
                                     - counts["pull_s"]) * 1e3
              / max(events, 1), "stats": batch.stats})
        others = {k: v for k, v in launches.items() if k != "market_clear"}
        if launches["market_clear"] < steps or steps <= 0 or \
                any(others.values()):
            fail(f"the {regime} parity runs made {steps} engine steps and "
                 f"launched {launches}")
        if got != committed or minus != "+0.000":
            fail(f"laissez_batch at {regime}: retention {got} (committed "
                 f"{committed}), batch minus event {minus}")
    topo = build_cluster({"H100": 16}, gpus_per_host=4, hosts_per_rack=2,
                         racks_per_zone=2)
    trace = market_trace(Market(topo), 0, 220)
    t0 = time.perf_counter()
    card, card_bm = _facade_replay(topo, trace, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu, cpu_bm = _facade_replay(topo, trace, "cpu")
    bad = [i for i, (g, c) in enumerate(zip(card, cpu)) if g != c]
    eng = card_bm.engines["H100"]
    small = _clear_card_vs_cpu(eng, card_bm.states["H100"],
                               cpu_bm.engines["H100"])
    n = FAULTS_10K["n_leaves"]
    est = storm_res.engine_state
    big_eng = BatchEngine(build_tree(n), capacity=est["price"].shape[0],
                          n_tenants=est["bills"].shape[0], k=FAULTS_10K["k"],
                          device=dev)
    big_cpu = BatchEngine(build_tree(n), capacity=est["price"].shape[0],
                          n_tenants=est["bills"].shape[0], k=FAULTS_10K["k"],
                          device="cpu")
    big = _clear_card_vs_cpu(big_eng, est, big_cpu)
    emit({"phase": "event_path", "case": "trace_card_vs_cpu",
          "events": len(trace), "differing_events": bad[:10],
          "stats": card[-1][3], "card_s": card_s,
          "ms_per_event": card_s * 1e3 / len(trace),
          "clear_differs_trace_book": small,
          "clear_differs_storm_book_10k": big,
          "wall_s": time.perf_counter() - t_phase})
    if bad or small or big:
        fail(f"the event path on the card differs from the CPU: events "
             f"{bad[:10]}, clear on the trace's book {small}, on the "
             f"storm's 10k book {big}")
    if card[-1][3]["transfers"] <= 0:
        fail("the differential trace moved no leaf")


# ------------------------------------------------------------------ phase 4
def phase_serve(dev, arch, traffic=SERVE_FULL):
    """A serving main path at full width, with every launch count set
    to 0 just before and read just after."""
    import torch
    from repro_torch.launch.serve import serve
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    t0 = time.perf_counter()
    rep = serve(arch, full=True, device=dev, **traffic)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    cfg = rep.cfg
    want = _expected_launches(cfg, rep)
    finite = bool(torch.isfinite(rep.server.last_logits).all())
    lengths = [len(r.out) for r in rep.requests]
    in_vocab = all(0 <= t < cfg.vocab_size for r in rep.requests
                   for t in r.out)
    windows = sorted({spec.window for spec in cfg.layer_plan()})
    emit({"phase": "serve_main_path", "arch": cfg.name, "full": True,
          "param_dtype": cfg.param_dtype, **traffic,
          "params_b": cfg.param_counts()[0] / 1e9,
          "windows": {w: sum(spec.window == w for spec in cfg.layer_plan())
                      for w in windows},
          "max_len": rep.server.max_len, "served": rep.served,
          "tokens_per_request": lengths, "prefills": rep.prefills,
          "decode_steps": rep.decode_steps, "launches": launches,
          "expected_launches": want, "logits_finite": finite,
          "tokens_in_vocab": in_vocab, **rep.metrics(),
          "ttft_ms_all": sorted(float(t * 1e3)
                                for t in rep.ttft_s.values()),
          "tick_ms": [float(t * 1e3) for t in rep.tick_s],
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "init_s": rep.init_s, "init_peak_gb": rep.init_peak_bytes / 1e9,
          "wall_with_init_s": wall})
    if rep.served != traffic["requests"] or \
            any(n != traffic["max_new"] for n in lengths) or not in_vocab:
        fail(f"serving main path finished {rep.served} requests with "
             f"{lengths} tokens (in vocab: {in_vocab})")
    if not finite:
        fail("serving main path produced non-finite logits")
    if launches != want or not any(want.values()):
        fail(f"the {cfg.name} serving main path launched {launches}; "
             f"expected {want}")
    return rep, launches


def phase_prefill_decode(dev, arch):
    """A frontend model at full width (bfloat16, random weights from
    ``torch.Generator`` seed 0): ``FRONTEND_FULL`` with seeded patch or
    frame embeddings, every launch count set to 0 just before and read
    just after.  Returns the config and the cache for the kernels line."""
    import torch
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, steps = (FRONTEND_FULL[k] for k in ("batch", "text_tokens",
                                              "steps"))
    batch = _frontend_batch(cfg, B, S, 6, dev)
    _reset_launches()
    toks, logits, cache, prefill_s, step_s = _prefill_decode(
        params, cfg, batch, steps)
    launches = _read_launches()
    want = _expected_launches(cfg, SimpleNamespace(prefills=1,
                                                   decode_steps=steps))
    finite = bool(torch.isfinite(logits).all())
    in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    emit({"phase": "prefill_decode_main_path", "arch": cfg.name,
          "full": True, "param_dtype": cfg.param_dtype,
          "params_b": cfg.param_counts()[0] / 1e9, "frontend": cfg.frontend,
          "prefix_or_frames": cfg.num_prefix_tokens, **FRONTEND_FULL,
          "tokens_shape": list(toks.shape), "logits_finite": finite,
          "tokens_in_vocab": in_vocab, "launches": launches,
          "expected_launches": want, "init_s": init_s,
          "prefill_ms": prefill_s * 1e3,
          "decode_ms_per_step_p50": sorted(step_s)[len(step_s) // 2] * 1e3,
          "decode_ms_all": [t * 1e3 for t in step_s],
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    if not (finite and in_vocab) or tuple(toks.shape) != (B, steps + 1):
        fail(f"{cfg.name} prefill/decode gave tokens {tuple(toks.shape)} "
             f"(in vocab {in_vocab}), finite logits {finite}")
    if launches != want or not want["decode_attention"]:
        fail(f"the {cfg.name} prefill/decode path launched {launches}; "
             f"expected {want}")
    return cfg, cache, launches


# ------------------------------------------------------------------ phase 4c
def _train_launches(cfg, steps):
    """Every kernel's launches in ``steps`` train steps: moe_route once
    per MoE layer and ssd_scan once per SSD layer in the forward, and
    once more per such layer of a superblock in the backward's remat
    recompute (``cfg.remat``; head and tail layers are not
    rematerialised); the SSD backward once per SSD layer (one
    ``_SSDScan.backward`` a layer, remat or not); decode_attention and
    market_clear never."""
    plan = cfg.layer_plan()
    head, p, n_super, _ = cfg.plan_blocks()
    runs = [2 if cfg.remat and head <= i < head + p * n_super else 1
            for i in range(len(plan))]
    return {"market_clear": 0, "decode_attention": 0,
            "moe_route": steps * sum(r for r, spec in zip(runs, plan)
                                     if spec.moe),
            "ssd_scan": steps * sum(r for r, spec in zip(runs, plan)
                                    if spec.kind == "ssm"),
            "ssd_scan_backward": steps * sum(spec.kind == "ssm"
                                             for spec in plan)}


def _route_grad(logits, k, renorm, dt, up, plain=False):
    """d sum(dense * up) / d logits through the router Function (or, with
    ``plain``, autograd through the plain version)."""
    import torch
    from repro_torch.kernels.moe_route import ops as RO
    from repro_torch.kernels.moe_route import ref as RR
    logits = logits.detach().clone().requires_grad_(True)
    fn = RR.route_dense_ref if plain else RO.route_dense
    _, _, dense = fn(logits, k, renorm, dt)
    loss = (dense.float() * up.float()).sum()
    return torch.autograd.grad(loss, logits)[0]


def _ssd_grads(xbc, dt, A, up, H, P, N, Q):
    """Gradients of sum(y * up) in the conv output ``xbc`` (x, Bm and Cm
    are its slices, as ``ssd_block`` passes them), dt and A through the
    SSD Function."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as SO
    ins = [t.detach().clone().requires_grad_(True) for t in (xbc, dt, A)]
    B, S = xbc.shape[:2]
    xs, Bm, Cm = torch.split(ins[0], [H * P, N, N], dim=-1)
    y, _ = SO.ssd_scan(xs.reshape(B, S, H, P), ins[1], ins[2], Bm, Cm, Q)
    return torch.autograd.grad((y.float() * up).sum(), ins)


def phase_train_kernels_vs_plain(dev):
    """The two Functions' backwards on the card: the router's logits
    gradient against the same Function's on the CPU (tied logits,
    within 1e-6) and against autograd through the plain version on the
    card (untied logits, within 1e-6: on ties that autograd follows
    torch's max, not the kernel's lowest index), at T 1,024 and 4,096, E
    64, k 8, renormalised and not, dense weights float32 and bfloat16;
    the SSD Function's input gradients through its backward kernel
    (one launch each) against the CPU's (float32, within 3e-4) at
    reduced mamba2's shape and at one full-width mamba2 layer's (1 x
    4,096 x 48 x 64, N 128, Q 256).  Then the backwards at each training
    path's shape: the router's closed form timed; the SSD backward
    kernel held to the plain version on the card in bfloat16 (within
    ``kernel.BWD_BF16_TOL`` of each gradient's largest magnitude) and
    timed beside it, with its bound and both peaks.  Returns those
    readings for the ``kernels`` line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_route import ops as RO
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR
    for T in (1024, 4096):
        for renorm in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                tied = _route_logits(T, 64, T, dev)
                untied = _randn((T, 64), T + 5, dev, torch.float32)
                up = _randn((T, 64), T + 7, dev, torch.float32).to(dt)
                g = _route_grad(tied, 8, renorm, dt, up)
                g_cpu = _route_grad(tied.cpu(), 8, renorm, dt, up.cpu())
                g_u = _route_grad(untied, 8, renorm, dt, up)
                g_plain = _route_grad(untied, 8, renorm, dt, up, plain=True)
                torch.cuda.synchronize()
                err_cpu = float((g.cpu() - g_cpu).abs().max())
                err_plain = float((g_u - g_plain).abs().max())
                scale = float(g_cpu.abs().max())
                ok = err_cpu <= 1e-6 and err_plain <= 1e-6 and scale > 0
                emit({"phase": "train_kernels_vs_plain", "kernel": "moe_route",
                      "case": f"grad_T{T}_E64_k8_renorm{int(renorm)}_"
                              f"{str(dt)[6:]}",
                      "max_abs_err_vs_cpu_tied": err_cpu,
                      "max_abs_err_vs_plain_autograd_untied": err_plain,
                      "grad_max_abs": scale, "tolerance": 1e-6, "ok": ok})
                if not ok:
                    fail(f"the router's backward on the card: T {T} renorm "
                         f"{renorm} {dt}: err vs CPU {err_cpu}, vs the plain "
                         f"version's autograd {err_plain}, scale {scale}")
    red = get_config("mamba2-780m").reduced()
    for name, (B, S, H, P, N, Q) in (
            ("reduced_mamba2", (2, 20, red.ssm_heads, red.ssm_headdim,
                                red.ssm_state, red.ssm_chunk)),
            ("mamba2_layer", (1, 4096, 48, 64, 128, 256))):
        xs, dt_, A, Bm, _ = SR.sample_inputs(B, S, H, P, N, S, "cpu",
                                             torch.float32)
        xbc = xs._base if xs._base is not None else xs
        up = _randn((B, S, H, P), S + 1, "cpu", torch.float32)
        before = SK.BACKWARD_LAUNCHES
        got = _ssd_grads(xbc.to(dev), dt_.to(dev), A.to(dev), up.to(dev),
                         H, P, N, Q)
        launched = SK.BACKWARD_LAUNCHES - before
        want = _ssd_grads(xbc, dt_, A, up, H, P, N, Q)
        errs = {n: float((g.cpu() - w).abs().max())
                for n, g, w in zip(("xbc", "dt", "A"), got, want)}
        ok = all(bool(torch.allclose(g.cpu(), w, rtol=3e-4, atol=3e-4))
                 and float(w.abs().max()) > 0 for g, w in zip(got, want)) \
            and launched == 1
        emit({"phase": "train_kernels_vs_plain", "kernel": "ssd_scan",
              "case": f"grad_{name}_float32", "shape": [B, S, H, P, N],
              "chunk": Q, "max_abs_err": errs,
              "grad_max_abs": {n: float(w.abs().max())
                               for n, w in zip(("xbc", "dt", "A"), want)},
              "backward_launches": launched, "tolerance": 3e-4, "ok": ok})
        if not ok:
            fail(f"the SSD backward on the card differs from the CPU's at "
                 f"{name}: {errs} ({launched} backward launches)")
    # the backwards' time at the training paths' shapes (bf16, as trained)
    T, E, k = 4096, 64, 8
    logits = _randn((T, E), 31, dev, torch.float32)
    w, idx, _ = RO._route(logits, k, False, torch.bfloat16)
    g_dense = _randn((T, E), 32, dev, torch.bfloat16)

    def route_bwd(i):
        return RO.route_backward(logits, idx, None, g_dense, False)
    route = {"route": "torch (closed form, kernels/moe_route/ops.py "
                      "route_backward)",
             "ms": _graph_ms(route_bwd, 50),
             "ms_eager": _time_ms(route_bwd, 50),
             "shape": {"T": T, "E": E, "k": k, "dense": "torch.bfloat16"}}
    ssd = _ssd_backward_numbers(dev)
    emit({"phase": "train_backward_times", "moe_route": route,
          "ssd_scan_backward": ssd})
    if not ssd["ok"]:
        fail(f"the SSD backward kernel differs from the plain version on "
             f"the card in bfloat16: {ssd['max_abs_err_by_grad']} against "
             f"{ssd['tolerance_of_max']} of {ssd['grad_max_abs']}")
    return {"moe_route": route, "ssd_scan_backward": ssd}


def _ssd_backward_operations(B, S, H, P, N, Q, with_state=False):
    """The least work the SSD backward needs on these shapes: products on
    the tensor cores (2 per multiply-add) and the float32 elementwise work
    beside them.  Products: C·Bᵀ over the pairs j <= i of each chunk
    (once for all heads); dW = gy·xᵀ and Wᵀ·gy over the pairs of each
    head; dGᵀ·C and dG·B once a chunk, not once a head (both are linear
    in dG, and Bm and Cm are shared by every head, so Σ_h dG_hᵀ·C =
    (Σ_h dG_h)ᵀ·C); the chunk states again (the forward's pass 1); each
    chunk's state gradient (gy exp(cum))ᵀ·C and gy·S_c past the first
    chunk (the state entering it is zero); and the carry's two terms B·Rᵀ
    and x·R wherever the state gradient leaving the chunk is not zero
    (every chunk but the last without an upstream gradient on the final
    state).  Elementwise, per head and pair: the decay L = E dt_j (E a
    product of two per-position exponentials; 2), W = G L and dG = dW L
    (2), dW W and its row and column sums (3), and the head sum of dG
    (1).  Returns (products, elementwise, parts)."""
    pairs = sum(nv * (nv + 1) // 2
                for nv in (min(Q, S - c0) for c0 in range(0, S, Q)))
    past_first = max(0, S - Q)
    carried = S if with_state else (S - 1) // Q * Q   # all but the last
    parts = {"gram": 2 * B * pairs * N,
             "dW": 2 * B * pairs * H * P,
             "gx_from_W": 2 * B * pairs * H * P,
             "gB_gC_from_dG": 2 * 2 * B * pairs * N,
             "state_recompute": 2 * B * S * H * P * N,
             "state_grad": 2 * B * past_first * H * P * N,
             "gC_from_state": 2 * B * past_first * H * P * N,
             "carry_terms": 2 * 2 * B * carried * H * P * N}
    products = sum(parts.values())
    parts["elementwise"] = 8 * B * pairs * H
    return products, parts["elementwise"], parts


def _ssd_backward_numbers(dev):
    """The SSD backward at mamba2-train's shape (B 4, S 4,096, H 48, P 64,
    N 128, Q 256, bfloat16, no upstream gradient on the final state, as
    training calls it): the kernel against the plain version on the card
    (``kernel.BWD_BF16_TOL``), the kernel's time in a CUDA graph and eager,
    the plain version's eager (autograd through ``ssd_scan_ref``; no
    graph), each one's peak memory above what the inputs hold, and the
    kernel's bound."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR
    B, S, H, P, N, Q = 4, 4096, 48, 64, 128, 256
    args = SR.sample_inputs(B, S, H, P, N, 33, dev, torch.bfloat16)
    g_y = _randn((B, S, H, P), 34, dev, torch.bfloat16)
    needs = (True,) * 5

    def kernel(i):
        return SK.ssd_scan_backward_cuda(*args, Q, g_y, None)

    def plain(i):
        return SR.ssd_scan_backward_ref(args, Q, g_y, None, needs)

    def peak_gb(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = fn(0)
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    got, kernel_gb = peak_gb(kernel)
    want, plain_gb = peak_gb(plain)
    names = ("x", "dt", "A", "Bm", "Cm")
    errs = {n: float((g.float() - w.float()).abs().max())
            for n, g, w in zip(names, got, want)}
    scale = {n: float(w.float().abs().max()) for n, w in zip(names, want)}
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    ok = finite and all(0 < scale[n] and errs[n] <= SK.BWD_BF16_TOL
                        * scale[n] for n in names)
    del got, want
    times = {"ms": _graph_ms(kernel, 10), "ms_eager": _time_ms(kernel, 10),
             "plain_ms": _time_ms(plain, 3)}
    esize = args[0].element_size()
    nbytes = (esize * (3 * B * S * H * P + 4 * B * S * N)  # x gy gx B C gB gC
              + 4 * (2 * B * S * H + 2 * H))               # dt gdt A gA
    ops, elementwise, parts = _ssd_backward_operations(B, S, H, P, N, Q)
    bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
    # the elementwise work runs beside the tensor cores, at the f32 rate
    elementwise_ms = elementwise / FP32_OPS_PER_S * 1e3
    if elementwise_ms > bound_ms:
        bound_ms, bound_by = elementwise_ms, "operations"
    return {"ok": ok, "max_abs_err_by_grad": errs, "grad_max_abs": scale,
            "tolerance_of_max": SK.BWD_BF16_TOL, "finite": finite,
            "max_abs_err": max(errs.values()), **times,
            "plain_route": "autograd through ssd_scan_ref "
                           "(kernels/ssd_scan/ref.py ssd_scan_backward_ref)",
            "plain_ms_is": "eager (host enqueue included)",
            "peak_extra_gb": kernel_gb, "plain_peak_extra_gb": plain_gb,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "operations": ops, "elementwise_operations": elementwise,
            "elementwise_ms": elementwise_ms, "operations_by_part": parts,
            "shape": {"B": B, "S": S, "H": H, "P": P, "N": N, "Q": Q,
                      "dtype": "torch.bfloat16", "g_state": None}}


def _train_batches(cfg, B, S, steps):
    """``SyntheticTokens`` batches 0 .. steps - 1 (numpy)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    data = SyntheticTokens(DataConfig(cfg.vocab_size, S, B, 0))
    return [data.batch(i) for i in range(steps)]


def _mesh_info(dev):
    """The trainer's one-rank (1, 1) mesh on ``dev``'s type (NCCL on the
    card, gloo on the CPU, one default group)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import MeshInfo
    return MeshInfo(make_mesh((1, 1), ("data", "model"), dev), ("data",),
                    "model")


def phase_reduced_train(dev, arch):
    """A reduced model (float32, no TF32) trained for 3 steps of
    ``make_train_step`` over the trainer's one-rank mesh (the MoE layers
    run ``moe_ep``) on the card and on the CPU from the same seeded
    parameters: every first-step gradient leaf within atol 1e-5 + rtol
    1e-3 of the CPU's and non-zero on the card (no gradient silently lost
    through a kernel), each loss within 1e-4, every launch count exact
    (``_train_launches``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import steps as TS
    from repro_torch.models.model import init_params
    from repro_torch.optim import AdamWConfig, make_train_state
    from repro_torch.tree import walk
    cfg = get_config(arch).reduced()
    mesh_card, mesh_cpu = _mesh_info(dev), _mesh_info("cpu")
    opt = AdamWConfig(lr=1e-2, warmup_steps=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = _to(params, dev)
    batches = _train_batches(cfg, 2, 20, 3)

    def on(d, b):
        return {k: torch.from_numpy(v).to(d) for k, v in b.items()}
    lg, gg = TS.loss_and_grads(card, cfg, on(dev, batches[0]),
                               TS.make_moe_fn(mesh_card))
    lc, gc_ = TS.loss_and_grads(params, cfg, on("cpu", batches[0]),
                                TS.make_moe_fn(mesh_cpu))
    names = [n for n, _, _ in walk(params)]
    bad, zero, worst = [], [], 0.0
    for n, g, c in zip(names, gg, gc_):
        g = g.cpu()
        worst = max(worst, float((g - c).abs().max()))
        if not torch.allclose(g, c, rtol=1e-3, atol=1e-5):
            bad.append(n)
        if not float(g.abs().max()) > 0:
            zero.append(n)
    del gg, gc_
    step = TS.make_train_step(cfg, opt, mesh_card)
    st_card = make_train_state(card, opt)
    st_cpu = make_train_state(params, opt)
    _reset_launches()
    card_losses = []
    for b in batches:
        st_card, m = step(st_card, on(dev, b))
        card_losses.append(float(m["loss"]))
    launches = _read_launches()
    cpu_losses = []
    step = TS.make_train_step(cfg, opt, mesh_cpu)
    for b in batches:
        st_cpu, m = step(st_cpu, on("cpu", b))
        cpu_losses.append(float(m["loss"]))
    loss_err = max(abs(a - b) for a, b in zip(card_losses, cpu_losses))
    first_err = abs(float(lg) - float(lc))
    want = _train_launches(cfg, len(batches))
    emit({"phase": "reduced_train_gpu_vs_cpu", "arch": cfg.name,
          "reduced": True, "mesh": [1, 1], "batch": 2, "seq_len": 20,
          "steps": 3,
          "grad_leaves": len(names), "grad_max_abs_err": worst,
          "grad_leaves_outside_tolerance": bad, "zero_grad_leaves": zero,
          "grad_tolerance": {"rtol": 1e-3, "atol": 1e-5},
          "losses_card": card_losses, "losses_cpu": cpu_losses,
          "loss_max_abs_err": max(loss_err, first_err),
          "loss_tolerance": 1e-4, "launches": launches,
          "expected_launches": want})
    if bad or zero or loss_err > 1e-4 or first_err > 1e-4 or \
            launches != want:
        fail(f"reduced {cfg.name} training on the card differs from the "
             f"CPU: grads outside tolerance {bad}, zero {zero}, loss err "
             f"{max(loss_err, first_err)}, launches {launches} (expected "
             f"{want})")


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _drop_share(records):
    """Dropped (token, expert) pairs over all pairs in ``moe_ep``'s
    ``DISPATCH`` records."""
    from repro_torch.models import layers as TL
    if not records:
        return None
    counts = [TL.dropped_pairs(r) for r in records]
    return sum(int(d) for d, _ in counts) / sum(int(n) for _, n in counts)


TRAIN_SUMMARY = {}               # phase_train's readings by arch


@contextlib.contextmanager
def _ssd_backward_routes():
    """Counts, while the block runs, ``_SSDScan.backward``'s calls
    (``ops.ssd_scan_backward``) and the plain backward's
    (``ref.ssd_scan_backward_ref``, the route of ``cpu`` and ``meta``
    tensors)."""
    from repro_torch.kernels.ssd_scan import ops as SO
    from repro_torch.kernels.ssd_scan import ref as SR
    counts = {"backward_calls": 0, "plain_backward_calls": 0}
    route, plain = SO.ssd_scan_backward, SR.ssd_scan_backward_ref

    def counted(key, fn):
        def call(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return call
    SO.ssd_scan_backward = counted("backward_calls", route)
    SR.ssd_scan_backward_ref = counted("plain_backward_calls", plain)
    try:
        yield counts
    finally:
        SO.ssd_scan_backward, SR.ssd_scan_backward_ref = route, plain


def phase_train(dev, arch, card):
    """A full-width train run through ``launch.train.train`` and
    ``Trainer.run`` on a one-rank NCCL group (the trainer's (1, 1) mesh,
    so the MoE layers run ``moe_ep``; bfloat16 params, random weights
    from ``torch.Generator`` seed 0 on the card, the synthetic batches,
    a checkpoint interval longer than the run), with every launch count
    set to 0 just before and read just after, and the share of
    (token, expert) pairs ``moe_ep`` dropped; then one more step's
    gradients outside the Trainer on its mesh: every parameter leaf (and
    every row of a stacked one) finite and non-zero.  The SSD backward
    kernel launches once per ``_SSDScan.backward`` call and the plain
    backward never runs on the card."""
    import shutil
    import torch
    from repro_torch.launch.train import train
    from repro_torch.models import layers as TL
    from repro_torch.models import steps as TS
    from repro_torch.models.model import MeshInfo
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import walk
    spec = TRAIN_FULL[arch]
    B, S, steps = spec["batch"], spec["seq_len"], spec["steps"]
    opt = AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup_steps"],
                      state_dtype=spec["state_dtype"])
    ckdir = OUT / f"train_ckpt_{arch}"
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    TL.DISPATCH = []
    t0 = time.perf_counter()
    with _ssd_backward_routes() as routes:
        tr, rep = train(arch, steps=steps, seq_len=S, global_batch=B,
                        full=True, ckpt_dir=str(ckdir), opt=opt,
                        checkpoint_every=steps + 1, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    dropped = _drop_share(TL.DISPATCH)
    TL.DISPATCH = None
    peak = torch.cuda.max_memory_allocated(dev)
    shutil.rmtree(ckdir, ignore_errors=True)
    cfg = tr.cfg
    want = _train_launches(cfg, steps)
    later = rep.step_s[1:]
    p50 = _pct(later, 0.5)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             tr.data.batch(steps).items()}
    mi = MeshInfo(tr.mesh, ("data",), "model")
    loss, grads = TS.loss_and_grads(tr.state["params"], cfg, batch,
                                    TS.make_moe_fn(mi))
    named = {}
    bad = []
    for (name, stacked, _), g in zip(walk(tr.state["params"]), grads):
        rows = g.unbind(0) if stacked else (g,)
        row_max = [float(r.abs().max()) for r in rows]
        finite = bool(torch.isfinite(g).all())
        if not finite or min(row_max) <= 0:
            bad.append(name)
        if any(key in name for key in ("router", "A_log", "dt_bias",
                                       "conv_w", "in_proj")):
            named[name] = {"finite": finite, "min_row_max_abs": min(row_max),
                           "rows": len(rows)}
    extra_loss = float(loss)
    n_leaves = len(grads)
    del grads, loss, batch
    finite = all(map(math.isfinite, rep.losses))
    emit({"phase": "train_main_path", "card": card, "arch": cfg.name,
          "full": True,
          "entry": "repro_torch.launch.train.train -> Trainer.run",
          "mesh": list(tr.mesh.shape), "group": _group_backend(),
          "moe": "moe_ep" if cfg.num_experts else None,
          "capacity_factor": cfg.capacity_factor if cfg.num_experts
          else None, "capacity_slots": TL.moe_capacity(cfg, B * S)
          if cfg.num_experts else None, "dropped_pair_share": dropped,
          "param_dtype": cfg.param_dtype, "params_b":
          cfg.param_counts()[0] / 1e9, "state_dtype": opt.state_dtype,
          "state_dtype_why": spec["why"], "batch": B, "seq_len": S,
          "steps": steps, "lr": opt.lr, "warmup_steps": opt.warmup_steps,
          "remat": cfg.remat, "remat_policy": cfg.remat_policy,
          "step_ms_first": rep.step_s[0] * 1e3,
          "step_ms_p50": p50 * 1e3, "step_ms_p95": _pct(later, 0.95) * 1e3,
          "step_ms_all": [t * 1e3 for t in rep.step_s],
          "tokens_per_s": B * S / p50, "peak_mem_gb": peak / 1e9,
          "losses": rep.losses, "loss_first": rep.losses[0],
          "loss_last": rep.losses[-1], "losses_finite": finite,
          "loss_fell": rep.losses[-1] < rep.losses[0],
          "stragglers": rep.stragglers, "launches": launches,
          "expected_launches": want, "ssd_backward_routes": routes,
          "wall_with_init_s": wall,
          "extra_step": {"loss": extra_loss, "grad_leaves": n_leaves,
                         "bad_leaves": bad, "named": named}})
    if not finite or not math.isfinite(extra_loss):
        fail(f"{cfg.name} training gave non-finite losses {rep.losses} "
             f"(extra step {extra_loss})")
    if launches != want:
        fail(f"the {cfg.name} train path launched {launches}; expected "
             f"{want}")
    if routes["plain_backward_calls"] or \
            routes["backward_calls"] != launches["ssd_scan_backward"]:
        fail(f"the {cfg.name} train path's SSD backwards: {routes}, "
             f"{launches['ssd_scan_backward']} kernel launches")
    if bad:
        fail(f"{cfg.name}: gradients non-finite or zero in {bad}")
    TRAIN_SUMMARY[arch] = {"losses": list(rep.losses),
                           "step_ms_p50": p50 * 1e3,
                           "step_ms_p95": _pct(later, 0.95) * 1e3}
    del tr, rep
    _release()
    return launches


def _group_backend() -> str:
    import torch.distributed as dist
    return str(dist.get_backend())


# one full-width OLMoE MoE layer for moe_ep_vs_plain: train_4k's 4,096
# tokens, the published widths, bfloat16, capacity factor 1.25
MOE_EP_LAYER = dict(T=4096, seed=0)


def _moe_ep_layer_inputs(cfg, T, seed):
    """Seeded inputs of one MoE layer on the CPU.  The hidden states
    share a common direction, as a trained model's do, so the experts'
    loads are uneven and pairs drop.  x is a multiple of 2**-6 in (-1,
    1) and the router a multiple of 2**-8 in [-1/8, 1/8]: every product
    is a multiple of 2**-14 and every sum of 2,048 of them stays below
    2**8, so the float32 logits are exact on both devices and the two
    routings are the same function of the same numbers."""
    import torch
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    g = torch.Generator().manual_seed(seed)
    shared = torch.randn(D, generator=g)
    x = 0.15 * shared + 0.5 * torch.randn(T, D, generator=g)
    x = (x * 64).round().clamp(-63, 63) / 64
    router = ((0.03 * torch.randn(D, E, generator=g)) * 256).round() \
        .clamp(-32, 32) / 256
    dt = getattr(torch, cfg.param_dtype)
    p = {"router": router,
         "wg": (0.02 * torch.randn(E, D, F, generator=g)).to(dt),
         "wu": (0.02 * torch.randn(E, D, F, generator=g)).to(dt),
         "wd": (0.02 * torch.randn(E, F, D, generator=g)).to(dt)}
    up = torch.randn(T, D, generator=g)
    return p, x.to(dt).reshape(1, T, D), up.reshape(1, T, D)


def _moe_ep_grads(cfg, p, x, up, dev):
    """``moe_ep`` on a one-rank mesh on ``dev``: its output, the
    gradients of sum(y * up) in x and the four leaves, and the dispatch
    that call recorded (``buf_tok``, per-expert counts)."""
    import torch
    from repro_torch.models import layers as TL
    mi = _mesh_info(dev)
    p = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
    x = x.to(dev).requires_grad_(True)
    TL.DISPATCH = []
    y = TL.moe_ep(p, cfg, x, mesh=mi.mesh, ep_axis=mi.ep_axis)
    (buf_tok, counts, _, _, _), = TL.DISPATCH
    TL.DISPATCH = None
    grads = torch.autograd.grad((y.float() * up.to(dev)).sum(),
                                [x] + [p[k] for k in sorted(p)])
    names = ["x"] + sorted(p)
    return (y.detach().cpu(), {n: g.cpu() for n, g in zip(names, grads)},
            buf_tok.cpu(), counts.cpu())


def phase_moe_ep_vs_plain(dev, card):
    """``moe_ep`` on the card (a one-rank NCCL mesh; the router is the
    moe_route kernel) against the same function on the CPU (a one-rank
    gloo mesh; the router's plain version) for one full-width OLMoE MoE
    layer (``MOE_EP_LAYER``: T 4,096, D 2,048, E 64, k 8, F 1,024,
    bfloat16, capacity 640 slots an expert): ``buf_tok`` and the
    per-expert pair and drop counts exactly equal, the output within the
    serving checks' bfloat16 tolerance (3e-2), and the gradients of x,
    the router and the three expert leaves within 3e-2 of the CPU's
    largest (the router's is float32, but it sums the bfloat16 expert
    outputs); all non-zero.  Prints the share of dropped (token, expert)
    pairs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as TL
    cfg = get_config(SERVE_ARCH)
    T = MOE_EP_LAYER["T"]
    p, x, up = _moe_ep_layer_inputs(cfg, T, MOE_EP_LAYER["seed"])
    t0 = time.perf_counter()
    y, g, buf, counts = _moe_ep_grads(cfg, p, x, up, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    y0, g0, buf0, counts0 = _moe_ep_grads(cfg, p, x, up, "cpu")
    cpu_s = time.perf_counter() - t0
    cap = TL.moe_capacity(cfg, T)
    dropped = (counts - cap).clamp(min=0)
    same = bool(torch.equal(buf, buf0) and torch.equal(counts, counts0))
    y_err = float((y.float() - y0.float()).abs().max())
    y_ok = bool(torch.allclose(y.float(), y0.float(), rtol=3e-2, atol=3e-2))
    grads = {}
    for n in g0:
        a, b = g[n].float(), g0[n].float()
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        grads[n] = {"max_abs_err": err, "cpu_max_abs": scale,
                    "ok": err <= 3e-2 * scale and scale > 0
                    and float(a.abs().max()) > 0}
    ok = same and y_ok and all(v["ok"] for v in grads.values())
    emit({"phase": "moe_ep_vs_plain", "card": card, "arch": cfg.name,
          "shape": {"T": T, "D": cfg.d_model, "E": cfg.num_experts,
                    "k": cfg.num_experts_per_tok, "F": cfg.moe_d_ff},
          "dtype": cfg.param_dtype, "capacity_factor": cfg.capacity_factor,
          "capacity_slots": cap, "buf_tok_and_counts_equal": same,
          "pairs": int(counts.sum()), "dropped_pairs": int(dropped.sum()),
          "dropped_pair_share": float(dropped.sum()) / float(counts.sum()),
          "experts_over_capacity": int((dropped > 0).sum()),
          "max_expert_load": int(counts.max()),
          "y_max_abs_err": y_err, "y_tolerance": 3e-2, "grads": grads,
          "grad_tolerance": "3e-2 x the CPU's max |grad| per leaf",
          "card_s": card_s, "cpu_s": cpu_s, "ok": ok})
    if not ok:
        fail(f"moe_ep on the card differs from the CPU: dispatch equal "
             f"{same}, y err {y_err}, grads {grads}")


def phase_launch_train_market(dev, card):
    """``launch.train.market_scenario`` (``tests/test_system.py``'s
    scenario: trainA holds both leaves for 8 steps, a rival outbids it
    for one, it resumes to 16, the rival leaves and trainA re-bids and
    resumes to 24) with reduced OLMoE (float32) on the card with
    ``max_devices`` 1, and the same scenario on the CPU, each of whose
    runs resumes from the card's checkpoint (step 0, the seeded initial
    state; then the card's steps 8 and 16, copied over the CPU's own
    after each run): float32 Adam at lr 1e-2 turns the devices' rounding
    into drift over 24 steps, so each run is held to a CPU run from the
    same state.  Must hold: 24 steps done, a restore per run, each run's
    losses equal to the CPU's within 1e-5 (sound runs read 9.5e-7), the
    loss falls, trainA billed, the router's launches exact.  One card
    holds one NCCL rank, so the resizes themselves are shown on CPU gloo
    ranks (``tests/test_torch_launch.py``)."""
    import shutil
    import torch
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import market_scenario
    from repro_torch.models.model import init_params
    from repro_torch.optim import AdamWConfig, make_train_state
    cfg = get_config(SERVE_ARCH).reduced()
    dcfg = DataConfig(cfg.vocab_size, 32, 4, 0)
    opt = AdamWConfig(lr=1e-2, warmup_steps=4)
    root = OUT / "market_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    dirs = {"card": root / "card", "cpu": root / "cpu"}
    state0 = make_train_state(init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), opt)
    for d in dirs.values():
        CheckpointManager(str(d)).save(0, state0)
    _reset_launches()
    reps, bills = market_scenario(cfg, dcfg, opt, str(dirs["card"]), 1, dev)
    launches = _read_launches()

    def card_state(i):
        name = f"ckpt_{8 * (i + 1):08d}.npz"
        shutil.copy(dirs["card"] / name, dirs["cpu"] / name)
    cpu_reps, cpu_bills = market_scenario(cfg, dcfg, opt, str(dirs["cpu"]),
                                          1, "cpu", after_run=card_state)
    shutil.rmtree(root, ignore_errors=True)
    losses = [r.losses for r in reps]
    cpu_losses = [r.losses for r in cpu_reps]
    err = max(abs(a - b) for la, lb in zip(losses, cpu_losses)
              for a, b in zip(la, lb))
    want = _train_launches(cfg, 24)
    steps = [r.steps_done for r in reps]
    restores = [r.restores for r in reps]
    bill = bills.get("trainA", 0.0)
    ok = (steps == [8, 16, 24] and restores == [1, 1, 1]
          and [len(x) for x in losses] == [8, 8, 8] and err <= 1e-5
          and losses[2][-1] < losses[0][0] and bill > 0
          and launches == want)
    emit({"phase": "launch_train_market", "card": card, "arch": cfg.name,
          "reduced": True,
          "entry": "repro_torch.launch.train.market_scenario",
          "max_devices": 1, "cpu_runs_resume_from": "the card's "
          "checkpoints at steps 0, 8 and 16", "steps_done": steps,
          "restores": restores,
          "resizes": [r.resizes for r in reps], "losses_card": losses,
          "losses_cpu": cpu_losses, "loss_max_abs_err": err,
          "loss_tolerance": 1e-5, "bill_trainA": bill,
          "bill_trainA_cpu": cpu_bills.get("trainA", 0.0),
          "launches": launches, "expected_launches": want,
          "resize_note": "one card holds one NCCL rank; the resizes run on "
                         "CPU gloo ranks (tests/test_torch_launch.py)",
          "ok": ok})
    if not ok:
        fail(f"the market-driven run on the card: steps {steps}, restores "
             f"{restores}, loss err {err}, bill {bill}, launches "
             f"{launches} (expected {want})")


# the dry run's cells traced on the host (this slice's second path)
DRYRUN_CELLS = (("llama3-405b", "train_4k", "single"),
                ("olmoe-1b-7b", "train_4k", "single"),
                ("gemma3-27b", "decode_32k", "single"),
                ("mamba2-780m", "prefill_32k", "multi"))
PEAK_BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
SHARDED_PEAK_LIMIT_GB = 72.0

_FLOOR = """
import json
from repro_torch.launch import dryrun
dryrun.start_fake_group(1)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import AdamWConfig
cfg = get_config({arch!r})
tr = cells.trace_cell(cells.build_cell(
    cfg, ShapeConfig("train_full", {S}, {B}, "train"),
    make_mesh((1, 1), ("data", "model"), "meta"),
    AdamWConfig(state_dtype={dtype!r})))
print("FLOOR " + json.dumps({{"flops": tr["flops"],
                              "bytes": tr["bytes accessed"]}}))
"""


def _host_env():
    """A subprocess environment for host-only work: the package on the
    path and no card visible."""
    import os
    return {**os.environ, "PYTHONPATH": str(HERE / "src"),
            "CUDA_VISIBLE_DEVICES": ""}


def _train_floor(arch, spec):
    """Rank 0's matrix FLOPs of one step of ``arch`` at ``spec``'s shape
    on a (1, 1) mesh, from the dry run's trace (a subprocess with its own
    fake group), and that over the bf16 tensor-core peak."""
    r = subprocess.run(
        [sys.executable, "-c", _FLOOR.format(
            arch=arch, S=spec["seq_len"], B=spec["batch"],
            dtype=spec["state_dtype"])],
        env=_host_env(), capture_output=True, text=True, timeout=300)
    line = [x for x in r.stdout.splitlines() if x.startswith("FLOOR ")]
    if r.returncode or not line:
        fail(f"the dry run's trace of the {arch} step failed: "
             f"{r.stderr[-2000:]}")
    got = json.loads(line[0][6:])
    return got["flops"], got["flops"] / PEAK_BF16_FLOPS * 1e3


def phase_sharded_train(dev, card):
    """The sharded step (``make_train_step`` with the state as DTensors
    placed by ``train_state_specs``, the batch by ``batch_specs``) on
    the trainer's one-rank (1, 1) NCCL mesh at olmoe-1b-7b's
    ``TRAIN_FULL`` (1 x 4,096 tokens, bfloat16 m and v, 6 steps) against
    the same step on plain tensors from the same seeded parameters and
    batches, run first: one rank runs the same local operations, so
    each step's loss and grad norm agree within 1e-6 relative.  Launch
    counts set to 0 just before the DTensor run and read just after
    (moe_route inside ``moe_ep``'s ``local_map``); step ms p50 / p95 of
    both runs beside ``train_olmoe``'s (the Trainer, also on DTensors);
    peak memory under 72 GB; and the dry run's tensor-core floor for
    the step: rank 0's matrix FLOPs over 989e12.  On the (1, 1) mesh
    ``layers.data_parallel`` holds, so every layer takes
    ``model._run_stack``'s ``dp_blocks`` branch on local tensors: the
    card runs the placement, the embedding, logits, loss and AdamW on
    DTensors and that branch, not the branch of a mesh with a "model"
    cut (``pin_batch``, ``_attend_blocks``, the vocab-cut embedding,
    ``split_heads``' gather), which the CPU gloo tests alone hold."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as SH
    from repro_torch.models import steps as TS
    from repro_torch.models.model import init_params
    from repro_torch.optim import AdamWConfig, make_train_state
    from repro_torch.tree import tree_leaves
    arch = SERVE_ARCH
    spec = TRAIN_FULL[arch]
    B, S, steps = spec["batch"], spec["seq_len"], spec["steps"]
    opt = AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup_steps"],
                      state_dtype=spec["state_dtype"])
    cfg = get_config(arch)
    mi = _mesh_info(dev)
    mesh = mi.mesh
    batches = _train_batches(cfg, B, S, steps)
    step = TS.make_train_step(cfg, opt, mi)
    runs = {}
    for placed in (False, True):
        gen = torch.Generator(device=dev).manual_seed(0)
        state = make_train_state(init_params(cfg, gen, dev), opt)
        if placed:
            state = SH.distribute(state, SH.train_state_specs(cfg, mesh),
                                  mesh)
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_launches()
        losses, norms, ms = [], [], []
        for b in batches:
            b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            if placed:
                b = SH.distribute(b, SH.batch_specs(cfg, mesh, B), mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(m["grad_norm"]))
        if placed:
            launches = _read_launches()
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            placements = sorted({str(t.placements) for t in
                                 tree_leaves(state["params"])})
        runs[placed] = (losses, norms, ms)
        del state
        _release()
    (pl, pn, pms), (dl, dn, dms) = runs[False], runs[True]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in
              zip(dl + dn, pl + pn))
    want = _train_launches(cfg, steps)
    flops, floor_ms = _train_floor(arch, spec)
    trainer = TRAIN_SUMMARY.get(arch, {})
    emit({"phase": "sharded_train", "card": card, "arch": cfg.name,
          "full": True, "mesh": list(mesh.shape), "group": _group_backend(),
          "entry": "repro_torch.models.steps.make_train_step on DTensors "
                   "(launch.shardings.distribute of train_state_specs)",
          "param_placements": placements, "batch": B, "seq_len": S,
          "steps": steps, "state_dtype": opt.state_dtype,
          "losses_dtensor": dl, "losses_plain": pl,
          "grad_norms_dtensor": dn, "grad_norms_plain": pn,
          "max_rel_diff": rel, "rel_tolerance": 1e-6,
          "step_ms_dtensor": dms, "step_ms_plain": pms,
          "step_ms_p50_dtensor": _pct(dms[1:], 0.5),
          "step_ms_p95_dtensor": _pct(dms[1:], 0.95),
          "step_ms_p50_plain": _pct(pms[1:], 0.5),
          "step_ms_p95_plain": _pct(pms[1:], 0.95),
          "step_ms_p50_trainer": trainer.get("step_ms_p50"),
          "step_ms_p95_trainer": trainer.get("step_ms_p95"),
          "trainer_losses_equal": trainer.get("losses") == dl,
          "peak_mem_gb": peak, "peak_limit_gb": SHARDED_PEAK_LIMIT_GB,
          "launches": launches, "expected_launches": want,
          "dryrun_matrix_flops": flops,
          "tensor_core_floor_ms": floor_ms,
          "floor_rate_flops_per_s": PEAK_BF16_FLOPS})
    if rel > 1e-6:
        fail(f"the DTensor step differs from the plain step by {rel} "
             f"(relative; losses {dl} vs {pl}, norms {dn} vs {pn})")
    if launches != want:
        fail(f"the sharded step launched {launches}; expected {want}")
    if peak >= SHARDED_PEAK_LIMIT_GB:
        fail(f"the sharded step peaked at {peak} GB")


def phase_dryrun():
    """The dry run (``python -m repro_torch.launch.dryrun``) of
    ``DRYRUN_CELLS`` at full width on the production meshes, each cell
    in its own process on the host (a fake group of 512 ranks, ``meta``
    tensors, no card), four at once: status, per-device FLOPs and bytes,
    wire bytes by collective, the analytic memory and whether it fits
    the card, the uneven leaves, and the host's trace seconds.  A cell
    that is not ``ok`` fails the run.  The card's memory size is held to
    ``analytic.HBM_BYTES``."""
    import torch
    from repro_torch.launch import analytic
    total = torch.cuda.get_device_properties(0).total_memory
    out = OUT / "dryrun_torch"
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out),
             "--force"], env=_host_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    cells = []
    for (arch, shape, mesh), proc in zip(DRYRUN_CELLS, procs):
        _, err = proc.communicate(timeout=600)
        path = out / f"{arch}__{shape}__{mesh}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        if proc.returncode or rec.get("status") != "ok":
            fail(f"dry run {arch} {shape} {mesh}: {rec.get('status')} "
                 f"{rec.get('error')} {err[-2000:]}")
        mem = rec["analytic_memory_per_dev"]
        cells.append({
            "arch": arch, "shape": shape, "mesh": mesh,
            "status": rec["status"], "n_devices": rec["n_devices"],
            "flops_per_dev": rec["flops_per_dev"],
            "bytes_per_dev": rec["bytes_per_dev"],
            "model_flops": rec["model_flops"]["model_flops"],
            "wire_bytes_by_op": {k: v["wire_bytes"] for k, v in
                                 rec["collectives"]["per_op"].items()},
            "wire_bytes": rec["collectives"]["wire_bytes"],
            "memory_analysis": rec["memory_analysis"],
            "analytic_memory_total": mem["total"],
            "fits_h100": mem["fits_h100"],
            "uneven_leaves": rec["uneven_leaves"],
            "trace_s_host": rec["trace_s"]})
    emit({"phase": "dryrun", "cells": cells,
          "card_total_memory": total, "analytic_hbm_bytes":
          analytic.HBM_BYTES})
    if total != analytic.HBM_BYTES:
        fail(f"the card holds {total} bytes; analytic.HBM_BYTES says "
             f"{analytic.HBM_BYTES}")


def _release() -> None:
    """Return the memory of a model the caller has dropped, before the
    next model's peak."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 5
def _time_ms(fn, reps):
    """CUDA-event time per call of ``fn(i)`` over ``reps`` calls, after
    a warm-up; ``i`` lets a caller rotate its inputs."""
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _graph_ms(fn, reps):
    """Device time per call of ``fn(i)``: ``reps`` calls captured in one
    CUDA graph and replayed, so the host's enqueue time (which exceeds a
    small kernel's run time on this path) is not in the timed span."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up off the default stream
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(3):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (3 * reps)


def _timings(kernel, plain, library, reps, plain_reps):
    """Device times (CUDA graph) and eager times (host enqueue
    included) of a kernel, its plain version and a library call."""
    return {"ms": _graph_ms(kernel, reps),
            "plain_ms": _graph_ms(plain, plain_reps),
            "library_ms": _graph_ms(library, reps),
            "ms_eager": _time_ms(kernel, reps),
            "plain_ms_eager": _time_ms(plain, plain_reps),
            "library_ms_eager": _time_ms(library, reps)}


def _clear_bound(aggs, n_leaves, k, strides):
    """Least time for one clearing pass on these inputs: each input read
    once and each output written once over the memory rate, or the
    operations this data needs over the float32 rate, whichever is
    larger.  The operations: one merge of two ranked k-lists (2k steps of
    a price and a seq compare) for each node under the root whose own
    list is live (a node with a dead list takes its parent's path), and
    the leaf stage (8 operations per slate column)."""
    pk = aggs[0]
    n_seg = pk.shape[0]
    in_bytes = 4 * (4 * n_seg * k + 4 * n_seg + n_seg + 2 * n_leaves)
    out_bytes = 4 * (4 * n_leaves + n_leaves * (k + 1))
    nbytes = in_bytes + out_bytes
    top_off = n_seg - (-(-n_leaves // strides[-1]))
    live_nodes = int((pk[:top_off, 0] > -5e29).sum())
    ops = live_nodes * 2 * k * 2 + n_leaves * 8 * (k + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def _market_clear_entry(res, launches):
    import torch
    from repro_torch.kernels.market_clear import kernel as K
    from repro_torch.kernels.market_clear import ref as R
    from repro_torch.sim.simulator import FLEET_10K
    k = FLEET_10K["k"]
    # the main path's last clearing inputs: its final book and owners
    tree, aggs, args = _final_book(res.engine_state, FLEET_10K["n_leaves"],
                                   k)
    n_seg = aggs[0].shape[0]
    plain, got = _clear_pair(aggs, args, k)
    if not all(torch.equal(a, b) for a, b in zip(plain, got)):
        fail("market_clear differs from its plain version on the main "
             "path's final book")
    err = float((plain[0] - got[0]).abs().max())
    ms = _graph_ms(lambda i: K.clear_cuda(*aggs, *args), 200)
    ms_eager = _time_ms(lambda i: K.clear_cuda(*aggs, *args), 200)
    # the plain version reads the device (a level's liveness), so it
    # cannot be captured: its time is eager
    plain_ms = _time_ms(lambda i: R.clear_sorted_from_aggs(aggs, *args, k),
                        20)
    bound_ms, bound_by, nbytes, ops = _clear_bound(aggs, tree.n_leaves, k,
                                                   tree.strides)
    kern = {"name": "market_clear", "route": "cuda",
            "source": "src/repro_torch/csrc/market_clear.cu",
            "replaces": "src/repro/kernels/market_clear/kernel.py:281",
            "launches": launches["market_clear"], "max_abs_err": err,
            "ms": ms, "ms_eager": ms_eager, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shapes": {"n_seg": int(n_seg), "k": k,
                       "n_leaves": tree.n_leaves},
            "bytes": nbytes, "operations": ops}
    return kern


def _bound(nbytes, ops, ops_per_s):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def _decode_numbers(ck, cv, G, pos, window, seed=7):
    """decode_attention on a path's caches ``ck``/``cv`` (L, B, S, K, hd)
    at ``pos`` and ``window``, one layer per call in turn, so that the
    calls find the keys and values of several layers as the model's
    layer loop does: its error against the plain version, the kernel's,
    the plain version's and SDPA's times on the same valid range, the
    bound from the bytes of the valid positions, and the split plan."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    n_layers, B, S, K, hd = ck.shape
    q = _randn((B, K, G, hd), seed, ck.device, ck.dtype)
    lo, hi, _ = DK.valid_range(S, pos, window)
    got = DK.decode_attention_cuda(q, ck[0], cv[0], pos, window)
    want = DR.decode_attention_ref(q, ck[0], cv[0], pos, window)

    def sdpa(i):
        kk = ck[i % n_layers][:, lo:hi + 1].transpose(1, 2)
        vv = cv[i % n_layers][:, lo:hi + 1].transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.reshape(B, K * G, 1, hd), kk, vv, enable_gqa=True)
    lib = sdpa(0).reshape(B, K, G, hd)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = 3e-2 if ck.dtype == torch.bfloat16 else 2e-5
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        fail(f"decode_attention differs from its plain version on a "
             f"serving path's cache {tuple(ck.shape)} at pos {pos} window "
             f"{window}: max err {err}")
    times = _timings(
        lambda i: DK.decode_attention_cuda(q, ck[i % n_layers],
                                           cv[i % n_layers], pos, window),
        lambda i: DR.decode_attention_ref(q, ck[i % n_layers],
                                          cv[i % n_layers], pos, window),
        sdpa, 160, 32)
    esize = ck.element_size()

    def nbytes(n):      # q and out once, the keys and values of n positions
        return esize * (2 * B * K * G * hd + 2 * B * n * K * hd)
    n = hi - lo + 1
    ops = 4 * B * K * G * n * hd                 # q.k and p.v, 2 flops each
    rate = BF16_OPS_PER_S if ck.dtype == torch.bfloat16 else FP32_OPS_PER_S
    bound_ms, bound_by = _bound(nbytes(n), ops, rate)
    full_ms, _ = _bound(nbytes(S), 4 * B * K * G * S * hd, rate)
    splits, split_len = DK.split_plan(
        n, B * K, torch.cuda.get_device_properties(ck.device)
        .multi_processor_count)
    return {"max_abs_err": err, **times, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_max_abs_err": float((lib.float() - got.float())
                                         .abs().max()),
            "shapes": {"B": B, "S": S, "K": K, "G": G, "hd": hd,
                       "pos": pos, "window": window, "lo": lo, "hi": hi,
                       "layers_rotated": n_layers, "dtype": str(ck.dtype)},
            "splits": splits, "split_len": split_len,
            "bytes": nbytes(n), "operations": ops,
            "bound_ms_full_S": full_ms}


def _decode_attention_entry(rep, launches):
    """At the serving main path's last decode step: the 16 layers'
    full-width caches (bfloat16, B 4, S 1,064, K 16, hd 128) at the last
    decode position, one layer per call in turn, so every call finds its
    ~35 MB of keys and values outside the 50 MB L2 as the model's layer
    loop does.  ``splits`` is the kernel's split-KV plan there.  The
    other serving paths' shapes join it under ``paths``."""
    blk = rep.server.cache["blocks"][0]
    G = rep.cfg.num_heads // rep.cfg.num_kv_heads
    pos = SERVE_FULL["prompt_len"] + SERVE_FULL["max_new"] - 2
    nums = _decode_numbers(blk["k"], blk["v"], G, pos, 0)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:78",
            "launches": launches["decode_attention"], **nums,
            "library": "F.scaled_dot_product_attention(enable_gqa=True)",
            "launches_by_path": {rep.cfg.name: launches["decode_attention"]},
            "paths": []}


def _decode_path_entry(entry, arch, launches, ck, cv, G, pos, window):
    """One more serving path's decode_attention numbers (its caches, its
    last decode position), added to the kernel's entry."""
    entry["launches_by_path"][arch] = launches["decode_attention"]
    entry["paths"].append({"path": arch,
                           "launches": launches["decode_attention"],
                           **_decode_numbers(ck, cv, G, pos, window)})


def _route_inputs(T, D, E, dev):
    """The router's inputs at T tokens of width D (seeded): bfloat16
    activations, a float32 router, and the logits product of both."""
    import torch
    x = _randn((T, D), 21 + T, dev, torch.bfloat16)
    router = _randn((D, E), 22, dev, torch.float32) * D ** -0.5
    return x, router, x.to(torch.float32) @ router


def _library_route(logits, k, renorm):
    """The library's routing after the product, as ``moe_dense`` would
    build it without the kernel: softmax -> topk -> renorm -> zeros ->
    ``scatter_`` -> bfloat16 combine weights."""
    import torch
    w, idx = torch.topk(torch.softmax(logits, dim=-1), k)
    if renorm:
        w = w / w.sum(dim=-1, keepdim=True)
    dense = torch.zeros(logits.shape, dtype=torch.float32,
                        device=logits.device)
    dense.scatter_(1, idx, w)
    return dense.to(torch.bfloat16)


def _route_timings(x, router, k, renorm):
    """Graph and eager ms of the router (``kernel``, on fixed logits) and
    of the sequence as ``moe_dense`` runs it: ``product`` (``x`` cast to
    float32, times ``router``) alone, ``seq`` (the product, then one
    router launch that also writes the bfloat16 combine weights) and
    ``seq_library`` (the product, then ``_library_route``)."""
    import torch
    from repro_torch.kernels.moe_route import kernel as RK
    bf16 = torch.bfloat16
    logits = x.to(torch.float32) @ router

    def product(i):
        return x.to(torch.float32) @ router
    fns = {"product": product,
           "kernel": lambda i: RK.route_cuda(logits, k, renorm, bf16),
           "seq": lambda i: RK.route_cuda(product(i), k, renorm, bf16),
           "seq_library": lambda i: _library_route(product(i), k, renorm)}
    reps = 500 if x.shape[0] < 64 else 200
    out = {}
    for name, fn in fns.items():
        out[f"{name}_ms"] = _graph_ms(fn, reps)
        out[f"{name}_ms_eager"] = _time_ms(fn, reps)
    return out


def _route_numbers(T, D, E, k, renorm, dev):
    """The router at T tokens: its dense output held to the plain
    version, its times and sequences (``_route_timings``), the plain
    version's and ``topk(softmax)``'s times, and the bound of the fused
    work: the logits read once (4TE bytes), w and idx (8Tk) and the
    bfloat16 dense row (2TE) written once."""
    import torch
    from repro_torch.kernels.moe_route import ref as RR
    x, router, logits = _route_inputs(T, D, E, dev)
    err = _check_route_dense(logits, k, renorm, torch.bfloat16,
                             f"main_path_T{T}")
    times = _route_timings(x, router, k, renorm)
    reps = 500 if T < 64 else 200
    times.update({
        "plain_ms": _graph_ms(lambda i: RR.route_dense_ref(
            logits, k, renorm, torch.bfloat16), 50),
        "plain_ms_eager": _time_ms(lambda i: RR.route_dense_ref(
            logits, k, renorm, torch.bfloat16), 50),
        "library_ms": _graph_ms(
            lambda i: torch.topk(torch.softmax(logits, dim=-1), k), reps),
        "library_ms_eager": _time_ms(
            lambda i: torch.topk(torch.softmax(logits, dim=-1), k), reps)})
    nbytes = 4 * T * E + 8 * T * k + 2 * T * E
    ops = 5 * T * E + 2 * k * T * E      # softmax, then k max-and-mask
    bound_ms, bound_by = _bound(nbytes, ops, FP32_OPS_PER_S)
    return {"max_abs_err": err, **times, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "operations": ops}


def _moe_route_entry(rep, launches, dev):
    """At the serving main path's shapes: a decode step's 4 tokens (most
    of the launches) and, beside it, a prefill's 1,024; logits from
    D 2,048 bfloat16 activations, dense weights in bfloat16."""
    cfg = rep.cfg
    E, k, renorm = cfg.num_experts, cfg.num_experts_per_tok, \
        cfg.moe_renormalize
    dec = _route_numbers(SERVE_FULL["slots"], cfg.d_model, E, k, renorm,
                         dev)
    pre = _route_numbers(SERVE_FULL["prompt_len"], cfg.d_model, E, k,
                         renorm, dev)
    seq_keys = [key for key in dec if key.startswith(("product", "seq"))]
    return {"name": "moe_route", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_route.cu",
            "replaces": "src/repro/kernels/moe_route/kernel.py:59",
            "launches": launches["moe_route"],
            "launches_by_path": {f"{cfg.name} serve": launches["moe_route"]},
            "max_abs_err": max(dec["max_abs_err"], pre["max_abs_err"]),
            "ms": dec["kernel_ms"], "ms_eager": dec["kernel_ms_eager"],
            **{key: dec[key] for key in (
                "plain_ms", "library_ms", "plain_ms_eager",
                "library_ms_eager", "bound_ms", "bound_by")},
            "library": "torch.topk(torch.softmax(logits, -1), k)",
            "sequence": {key: dec[key] for key in seq_keys},
            "shapes": {"T": SERVE_FULL["slots"], "E": E, "k": k,
                       "D": cfg.d_model, "renormalize": renorm,
                       "logits": "torch.float32",
                       "dense": "torch.bfloat16"},
            "bytes": dec["bytes"], "operations": dec["operations"],
            "prefill": pre}


def _ssd_operations(B, S, H, P, N, Q):
    """Operations the SSD scan needs on these shapes (2 per
    multiply-add): C·Bᵀ and the causal y over the pairs j <= i of each
    chunk, the state update over every position, and y from the carried
    state over the positions past the first chunk (the state entering
    the first chunk is zero)."""
    pairs = sum(nv * (nv + 1) // 2
                for nv in (min(Q, S - c0) for c0 in range(0, S, Q)))
    parts = {"gram": 2 * B * pairs * N,
             "causal_y": 2 * B * pairs * H * P,
             "state_update": 2 * B * S * H * P * N,
             "y_from_state": 2 * B * max(0, S - Q) * H * P * N}
    return sum(parts.values()), parts


def _ssd_scan_entry(rep, launches, measured):
    """At the mamba2 serving main path's prefill shape: one 1,024-token
    prompt (B 1, H 48, P 64, N 128, Q 256, bfloat16), on the inputs and
    with the error of ``phase_ssd_vs_plain``'s case at that shape.  The
    15 MB of inputs stay in the 50 MB L2 between calls, as they do
    between the conv that writes them and the scan on the main path."""
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR
    cfg = rep.cfg
    B, S, Q = 1, SERVE_FULL["prompt_len"], cfg.ssm_chunk
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    key = (B, S, H, P, N, Q, cfg.param_dtype)
    if key not in measured:
        fail(f"phase_ssd_vs_plain has no case at the serving shape {key}")
    args, err = measured[key]

    def kernel(i):
        return SK.ssd_scan_cuda(*args, Q)

    def plain(i):
        return SR.ssd_scan_ref(*args, Q)
    times = {"ms": _graph_ms(kernel, 40), "plain_ms": _graph_ms(plain, 10),
             "ms_eager": _time_ms(kernel, 40),
             "plain_ms_eager": _time_ms(plain, 10)}
    esize = args[0].element_size()
    nbytes = (esize * (2 * B * S * H * P + 2 * B * S * N)    # x, y, Bm, Cm
              + 4 * (B * S * H + H + B * H * P * N))       # dt, A, state
    ops, parts = _ssd_operations(B, S, H, P, N, Q)
    # the contractions run on the tensor cores at the inputs' rate (bf16
    # on the main path); the bound at the CUDA cores' float32 rate beside
    rate = BF16_OPS_PER_S if cfg.param_dtype == "bfloat16" \
        else FP32_OPS_PER_S
    bound_ms, bound_by = _bound(nbytes, ops, rate)
    fp32_ms, _ = _bound(nbytes, ops, FP32_OPS_PER_S)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:70",
            "launches": launches["ssd_scan"],
            "launches_by_path": {f"{cfg.name} serve": launches["ssd_scan"]},
            "max_abs_err": err, **times,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_fp32_cores": fp32_ms, "library_ms": None,
            "library": "none (no single PyTorch call computes the scan)",
            "shapes": {"B": B, "S": S, "H": H, "P": P, "N": N, "Q": Q,
                       "dtype": cfg.param_dtype},
            "bytes": nbytes, "operations": ops, "operations_by_part": parts}


def _ssd_scan_backward_entry(ssd, launches):
    """The SSD backward kernel at mamba2-train's shape, with its launches
    on that path (``train_mamba2``); the Pallas kernel has no backward,
    so it replaces no TPU kernel: the reference differentiates
    ``ssd_chunked`` with XLA's autodiff."""
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "ms_eager", "plain_ms_is", "plain_route", "peak_extra_gb",
            "plain_peak_extra_gb", "max_abs_err_by_grad", "grad_max_abs",
            "tolerance_of_max", "shape", "bytes", "operations",
            "elementwise_operations", "elementwise_ms", "operations_by_part")
    n = launches["ssd_scan_backward"]
    return {"name": "ssd_scan_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "none: src/repro/kernels/ssd_scan/kernel.py:70 has "
                        "no backward (the reference takes XLA's autodiff of "
                        "src/repro/models/layers.py:308 ssd_chunked)",
            "launches": n,
            "launches_by_path": {f"{SSM_ARCH} train": n},
            **{k: ssd[k] for k in keep}, "library_ms": None,
            "library": "none (no single PyTorch call computes the scan's "
                       "gradients)"}


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t1, 3)
        return out
    card = timed("build", phase_card_and_build)
    timed("kernel_vs_plain", phase_kernel_vs_plain, dev)
    timed("model_kernels_vs_plain", phase_model_kernels_vs_plain, dev)
    ssd_measured = timed("ssd_vs_plain", phase_ssd_vs_plain, dev)
    timed("small_slice", phase_small_slice, dev)
    timed("decode_shapes_vs_plain", phase_decode_shapes_vs_plain, dev)
    decode_cut = timed("decode_cut", phase_decode_cut, dev)
    _release()
    timed("reduced_olmoe", phase_reduced_server, dev, SERVE_ARCH, 8)
    # a whole chunk and a part
    timed("reduced_mamba2", phase_reduced_server, dev, SSM_ARCH, 20)
    # 20 tokens: past the reduced window of 16, in prefill and decode
    for arch in ("qwen3-0.6b", DENSE_ARCH, "h2o-danube-1.8b",
                 "jamba-v0.1-52b", "kimi-k2-1t-a32b"):
        timed(f"reduced_{arch}", phase_reduced_server, dev, arch, 20)
    for arch in ("paligemma-3b", "whisper-base"):
        timed(f"reduced_{arch}", phase_reduced_prefill_decode, dev, arch)
    fleet_res, fleet_launches = timed("main_path", phase_main_path, dev)
    kernels = [_market_clear_entry(fleet_res, fleet_launches)]
    timed("state_checker", phase_state_checker, dev, card, fleet_res)
    timed("fig06_scale", phase_fig06_scale, dev, fleet_res)
    storm = timed("faults", phase_faults, dev)
    timed("recovery", phase_recovery, dev, *storm)
    timed("event_path", phase_event_path, dev, storm[0])
    rep, launches = timed("serve_olmoe", phase_serve, dev, SERVE_ARCH)
    decode = _decode_attention_entry(rep, launches)
    decode["partial"] = decode_cut
    kernels += [decode, _moe_route_entry(rep, launches, dev)]
    del rep                    # free OLMoE before the next path's peak
    _release()
    rep, launches = timed("serve_mamba2", phase_serve, dev, SSM_ARCH)
    kernels.append(_ssd_scan_entry(rep, launches, ssd_measured))
    del rep
    _release()
    # this slice's main path: gemma3-27b at full width; 52 of its 62
    # layers attend within a window of 1,024 at every decode position
    rep, launches = timed("serve_gemma3", phase_serve, dev, DENSE_ARCH)
    cfg = rep.cfg
    blk = rep.server.cache["blocks"][0]          # a local (windowed) layer
    _decode_path_entry(decode, cfg.name, launches, blk["k"], blk["v"],
                       cfg.num_heads // cfg.num_kv_heads,
                       SERVE_FULL["prompt_len"] + SERVE_FULL["max_new"] - 2,
                       cfg.layer_plan()[0].window)
    del rep, blk
    _release()
    rep, launches = timed("serve_qwen3", phase_serve, dev, "qwen3-0.6b")
    decode["launches_by_path"][rep.cfg.name] = launches["decode_attention"]
    del rep
    _release()
    rep, launches = timed("serve_danube", phase_serve, dev,
                          "h2o-danube-1.8b", DANUBE_SERVE)
    cfg = rep.cfg
    blk = rep.server.cache["blocks"][0]
    _decode_path_entry(decode, cfg.name, launches, blk["k"], blk["v"],
                       cfg.num_heads // cfg.num_kv_heads,
                       DANUBE_SERVE["prompt_len"] + DANUBE_SERVE["max_new"]
                       - 2, cfg.sliding_window)
    del rep, blk
    _release()
    steps = FRONTEND_FULL["steps"]
    cfg, cache, launches = timed("prefill_decode_paligemma",
                                 phase_prefill_decode, dev, "paligemma-3b")
    blk = cache["blocks"][0]
    _decode_path_entry(decode, cfg.name, launches, blk["k"], blk["v"],
                       cfg.num_heads // cfg.num_kv_heads,
                       blk["k"].shape[2] - 1, 0)
    del cache, blk
    _release()
    cfg, cache, launches = timed("prefill_decode_whisper",
                                 phase_prefill_decode, dev, "whisper-base")
    blk = cache["blocks"][0]                     # cross K/V: every frame
    _decode_path_entry(decode, cfg.name, launches, blk["cross_k"],
                       blk["cross_v"], cfg.num_heads // cfg.num_kv_heads,
                       blk["cross_k"].shape[2] - 1, 0)
    del cache, blk
    _release()
    # this slice's main paths: training on one device
    backward = timed("train_kernels_vs_plain", phase_train_kernels_vs_plain,
                     dev)
    timed("moe_ep_vs_plain", phase_moe_ep_vs_plain, dev, card)
    _release()
    for arch in (SERVE_ARCH, SSM_ARCH, "jamba-v0.1-52b"):
        timed(f"reduced_train_{arch}", phase_reduced_train, dev, arch)
    for arch, name in ((SERVE_ARCH, "moe_route"), (SSM_ARCH, "ssd_scan")):
        launches = timed(f"train_{arch.split('-')[0]}", phase_train, dev,
                         arch, card)
        entry = next(e for e in kernels if e["name"] == name)
        entry["launches_by_path"][f"{arch} train"] = launches[name]
        if name == "moe_route":
            entry["backward"] = backward[name]
    # the SSD backward's launches: train_mamba2's, the loop's last run
    kernels.append(_ssd_scan_backward_entry(backward["ssd_scan_backward"],
                                            launches))
    timed("launch_train_market", phase_launch_train_market, dev, card)
    # this slice's main paths: the sharded step and the dry run
    timed("sharded_train", phase_sharded_train, dev, card)
    timed("dryrun", phase_dryrun)
    emit({"kernels": kernels})
    emit({"phase": "done", "card": card, "phase_s": phase_s,
          "total_s": round(time.perf_counter() - t0, 3)})
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.jsonl").write_text("\n".join(_LINES) + "\n")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
