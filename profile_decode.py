#!/usr/bin/env python3
"""The decode-attention kernel alone at the serving paths' shapes, in
turns with another checkout.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 profile_decode.py                 # this checkout's kernel
    python3 profile_decode.py --compare DIR   # DIR, here, here, DIR
    python3 profile_decode.py --compare DIR --serve gemma3-27b

One run imports ``repro_torch`` from ``--root`` (default: this checkout)
and, at each of ``SHAPES`` (bfloat16: OLMoE, gemma3's local layer,
qwen3, danube, paligemma, whisper's cross-attention, gemma3's global
cache at position 20,000, and the partial mode on one of 4 blocks of that
cache and on jamba's rank block), times the kernel in a CUDA graph over
enough copies of the cache (at least 200 MB, so each call finds its keys
and values outside the 50 MB L2, as a decode step's layer loop does),
beside the library call on the same copies (SDPA with ``enable_gqa`` over
the valid range; for the partial mode flash attention with its
logsumexp, all ``merge_partials`` needs) and the bound (the valid
positions' keys and values, q and the outputs once over 3.35 TB/s, or
the flops over the bf16 rate).  It also times both calls eagerly (back
to back, the host's enqueue included: what a decode step outside a graph
pays) and the host's own time a call (the enqueue loop's wall time), the
median of 5 windows each, and records the split plan, the error against
the plain version and whether two calls give the same bits.  ``--serve
ARCH`` then serves
``chip_smoke.SERVE_FULL``'s traffic at ARCH's full width twice on the
same weights and records the second drain's metrics (decode ms per step
p50 / p95, TTFT, tokens per second).  ``--compare DIR`` runs DIR, this
checkout, this checkout, DIR in four child processes on one card, so two
versions (DIR unpacked from another commit with ``git archive``) are
compared in turns.  Lines go to ``chiprun_out/profile_decode.jsonl``.
Needs CUDA; it never runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "chiprun_out"
ROTATE_BYTES = 200e6          # copies of a cache cycled through, at least
# (name, B, S, K, G, hd, pos, window, partial block or 0): the block is
# positions 0.. of the cache (fully valid at pos)
SHAPES = (
    ("olmoe", 4, 1064, 16, 1, 128, 1054, 0, 0),
    ("gemma3_local", 4, 1064, 16, 2, 128, 1054, 1024, 0),
    ("qwen3", 4, 1064, 8, 2, 128, 1054, 0, 0),
    ("danube", 2, 4184, 8, 4, 80, 4170, 4096, 0),
    ("paligemma", 2, 280, 1, 8, 256, 279, 0, 0),
    ("whisper_cross", 2, 1500, 8, 1, 64, 1499, 0, 0),
    ("gemma3_global_32k", 4, 32768, 16, 2, 128, 20000, 0, 0),
    ("gemma3_global_block", 4, 32768, 16, 2, 128, 20000, 0, 8192),
    ("jamba_block", 4, 8192, 8, 4, 128, 4106, 0, 2048),
)


def _eager_ms(fn, reps, windows=5):
    """``(eager ms, host ms)`` a call of ``fn(i)``: CUDA events around
    ``reps`` back-to-back calls, and the host's wall time to enqueue them
    (the launch queue does not fill in ``reps`` calls), the median over
    ``windows`` windows after a warm-up."""
    import statistics
    import time

    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    eager, host = [], []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        host.append((time.perf_counter() - t0) * 1e3 / reps)
        b.record()
        torch.cuda.synchronize()
        eager.append(a.elapsed_time(b) / reps)
    return statistics.median(eager), statistics.median(host)


def _shape_numbers(name, B, S, K, G, hd, pos, window, block, DK, DR):
    """One shape's readings with the imported kernel module ``DK`` and
    plain module ``DR``."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import BF16_OPS_PER_S, _bound, _graph_ms
    dev = torch.device("cuda", 0)
    dt = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(S + G)
    n_pos = block or S
    kv_bytes = 2 * 2 * B * n_pos * K * hd
    copies = max(1, min(512, math.ceil(ROTATE_BYTES / kv_bytes)))
    q = torch.randn((B, K, G, hd), generator=gen, device=dev).to(dt)
    ks = [torch.randn((B, n_pos, K, hd), generator=gen, device=dev).to(dt)
          for _ in range(copies)]
    vs = [torch.randn((B, n_pos, K, hd), generator=gen, device=dev).to(dt)
          for _ in range(copies)]
    reps = max(160, copies)
    if block:
        lo, hi, _ = DK.valid_range(block, pos, window)

        def kern(i):
            return DK.decode_attention_partial_cuda(
                q, ks[i % copies], vs[i % copies], pos, window, 0)

        def plain(i):
            return DR.decode_attention_partial_ref(
                q, ks[i % copies], vs[i % copies], pos, window, 0)

        def lib(i):
            return torch.ops.aten._scaled_dot_product_flash_attention(
                q, ks[i % copies].transpose(1, 2),
                vs[i % copies].transpose(1, 2), 0.0, False, False)[:2]
        n = hi - lo + 1
        nbytes = 2 * (B * K * G * hd + 2 * B * n * K * hd) \
            + 4 * (B * K * G * hd + 2 * B * K * G)
        library = "aten._scaled_dot_product_flash_attention (out, lse)"
    else:
        lo, hi, _ = DK.valid_range(S, pos, window)

        def kern(i):
            return DK.decode_attention_cuda(q, ks[i % copies],
                                            vs[i % copies], pos, window)

        def plain(i):
            return DR.decode_attention_ref(q, ks[i % copies],
                                           vs[i % copies], pos, window)

        def lib(i):
            return F.scaled_dot_product_attention(
                q.reshape(B, K * G, 1, hd),
                ks[i % copies][:, lo:hi + 1].transpose(1, 2),
                vs[i % copies][:, lo:hi + 1].transpose(1, 2),
                enable_gqa=True)
        n = hi - lo + 1
        nbytes = 2 * (2 * B * K * G * hd + 2 * B * n * K * hd)
        library = "F.scaled_dot_product_attention(enable_gqa=True)"
    got, want = kern(0), plain(0)
    again = kern(0)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    again = again if isinstance(again, tuple) else (again,)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ops = 4 * B * K * G * n * hd
    bound_ms, bound_by = _bound(nbytes, ops, BF16_OPS_PER_S)
    plan = getattr(DK, "launch_plan", None)
    if plan is not None:
        splits = plan(dev, dt, B, K, G, hd, n)
    else:
        splits = DK.split_plan(n, B * K, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    ms = _graph_ms(kern, reps)
    lib_ms = _graph_ms(lib, reps)
    eager_ms, host_ms = _eager_ms(kern, reps)
    lib_eager_ms, lib_host_ms = _eager_ms(lib, reps)
    row = {"shape": name, "B": B, "S": S, "K": K, "G": G, "hd": hd,
           "pos": pos, "window": window, "block": block, "valid": n,
           "copies": copies, "splits": list(splits), "ms": ms,
           "eager_ms": eager_ms, "host_ms": host_ms, "library_ms": lib_ms,
           "library_eager_ms": lib_eager_ms, "library_host_ms": lib_host_ms,
           "library": library,
           "bound_ms": bound_ms,
           "bound_by": bound_by, "hbm_share": bound_ms / ms,
           "max_abs_err": err, "bit_equal_run_to_run": same,
           "bytes": nbytes}
    del ks, vs
    torch.cuda.empty_cache()
    return row


def _serve_numbers(arch: str) -> dict:
    """ARCH served at full width twice on the same weights (the first
    drain builds and warms up); the second drain's metrics."""
    import torch
    from chip_smoke import SERVE_FULL
    from repro_torch.launch.serve import serve
    dev = torch.device("cuda", 0)
    rep = serve(arch, full=True, device=dev, **SERVE_FULL)
    params = rep.server.params
    del rep
    out = serve(arch, full=True, device=dev, params=params,
                **SERVE_FULL).metrics()
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, **out}


def run_one(root: pathlib.Path, arch) -> dict:
    import torch
    sys.path.insert(0, str(root / "src"))
    from profile_clear import _card
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    torch.cuda.set_device(0)
    torch.cuda._sleep(int(5e8))      # ~0.3 s busy: the clocks ramp up first
    torch.cuda.synchronize()
    rows = [_shape_numbers(*s, DK, DR) for s in SHAPES]
    out = {"root": str(root), "card": _card(), "torch": torch.__version__,
           "shapes": rows}
    if arch:
        out["serve"] = _serve_numbers(arch)
    return out


def _summary(runs):
    """Per shape: this checkout's and the other's graph and eager ms (both
    turns), the library call's and the bound; then the served arch's
    decode p50 in both."""
    here = [r for r in runs if r["root"] == str(HERE)]
    other = [r for r in runs if r["root"] != str(HERE)]
    lines = []
    for i, s in enumerate(SHAPES):
        mine = [r["shapes"][i] for r in here]
        theirs = [r["shapes"][i] for r in other]
        lines.append({
            "shape": s[0],
            "ms": [x["ms"] for x in mine],
            "parent_ms": [x["ms"] for x in theirs],
            "eager_ms": [x["eager_ms"] for x in mine],
            "parent_eager_ms": [x["eager_ms"] for x in theirs],
            "host_ms": [x["host_ms"] for x in mine],
            "parent_host_ms": [x["host_ms"] for x in theirs],
            "library_ms": [x["library_ms"] for x in mine + theirs],
            "bound_ms": mine[0]["bound_ms"],
            "hbm_share": [x["hbm_share"] for x in mine],
            "splits": mine[0]["splits"],
            "parent_splits": theirs[0]["splits"] if theirs else None,
            "max_abs_err": [x["max_abs_err"] for x in mine + theirs],
            "bit_equal": all(x["bit_equal_run_to_run"]
                             for x in mine + theirs)})
    if "serve" in runs[0]:
        lines.append({
            "serve": runs[0]["serve"]["arch"],
            "decode_ms_per_step_p50": [r["serve"]["decode_ms_per_step_p50"]
                                       for r in here],
            "parent_decode_ms_per_step_p50": [
                r["serve"]["decode_ms_per_step_p50"] for r in other]})
    return lines


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose repro_torch is timed")
    ap.add_argument("--compare", type=pathlib.Path, default=None,
                    help="another checkout: run it, here, here, it")
    ap.add_argument("--serve", default=None, metavar="ARCH",
                    help="also serve ARCH at full width (e.g. gemma3-27b)")
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)   # a --compare turn: print only
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    if a.compare is None:
        runs = [run_one(a.root.resolve(), a.serve)]
        lines = [json.dumps(r) for r in runs]
    else:
        runs = []
        for root in (a.compare, HERE, HERE, a.compare):
            cmd = [sys.executable, str(HERE / "profile_decode.py"), "--root",
                   str(root.resolve()), "--child"]
            if a.serve:
                cmd += ["--serve", a.serve]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=900)
            if res.returncode != 0:
                raise SystemExit(f"profile_decode failed for {root}:\n"
                                 f"{res.stderr[-4000:]}")
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        lines = [json.dumps(r) for r in runs]
        lines += [json.dumps({"summary": x}) for x in _summary(runs)]
    if not a.child:
        OUT.mkdir(exist_ok=True)
        with open(OUT / "profile_decode.jsonl", "a") as f:
            f.write("\n".join(lines) + "\n")
    for line in lines:
        print(line, flush=True)


if __name__ == "__main__":
    main()
