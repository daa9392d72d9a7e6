#!/usr/bin/env python3
"""The MoE router's routing after the logits product, at OLMoE's serving
shapes, in turns with another checkout.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 profile_route.py                  # this checkout's router
    python3 profile_route.py --compare DIR    # DIR, here, here, DIR

One run imports ``repro_torch`` from ``--root`` (default: this
checkout) and, for ``olmoe-1b-7b`` (E 64, k 8, d_model 2,048) at T 4 (a
decode step of 4 slots) and T 1,024 (a prefill), prints one JSON line
with the graph and eager ms of the routing as that checkout's
``moe_dense`` runs it (``routing``, on fixed logits), of the logits
product alone (``product``) and of the product followed by the routing
(``seq``).  A router that writes the dense combine weights routes in
one launch; an older one (no ``dense_dtype``) runs the router and then
zeros -> ``idx.long()`` -> ``scatter_`` -> bfloat16.  Beside them, the
launch floor: ``floor``, an empty kernel (``torch.cuda._sleep(0)``),
and ``seq_floor``, the product and then that empty kernel, the least
any separate routing launch can add to the product.
``routing_host_ms`` is the host's time to enqueue the routing
(``profile_clear._host_ms``).  ``--compare DIR`` runs DIR, this
checkout, this checkout, DIR in four child processes on one card, so
two versions (DIR unpacked from another commit with ``git archive``)
are compared in turns.  Lines go to ``chiprun_out/profile_route.jsonl``.
Needs CUDA; it never runs on the CPU.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "chiprun_out"


def run_one(root: pathlib.Path) -> dict:
    import torch
    sys.path.insert(0, str(root / "src"))
    from chip_smoke import SERVE_ARCH, SERVE_FULL, _graph_ms, \
        _route_inputs, _time_ms
    from profile_clear import _card, _host_ms
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_route import kernel as RK
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = get_config(SERVE_ARCH)
    E, k, renorm = cfg.num_experts, cfg.num_experts_per_tok, \
        cfg.moe_renormalize
    one_launch = "dense_dtype" in inspect.signature(RK.route_cuda).parameters
    bf16 = torch.bfloat16
    row = {"root": str(root), "card": _card(), "one_launch": one_launch}
    for T in (SERVE_FULL["slots"], SERVE_FULL["prompt_len"]):
        x, router, logits = _route_inputs(T, cfg.d_model, E, dev)

        def routing(lg):
            if one_launch:
                return RK.route_cuda(lg, k, renorm, bf16)
            w, idx = RK.route_cuda(lg, k, renorm)
            d = torch.zeros((T, E), dtype=torch.float32, device=dev)
            d.scatter_(1, idx.long(), w)
            return d.to(bf16)

        def product(i):
            return x.to(torch.float32) @ router

        def seq_floor(i):
            product(i)
            torch.cuda._sleep(0)
        fns = {"routing": lambda i: routing(logits), "product": product,
               "seq": lambda i: routing(product(i)),
               "floor": lambda i: torch.cuda._sleep(0),
               "seq_floor": seq_floor}
        reps = 500 if T < 64 else 200
        times = {}
        for name, fn in fns.items():
            times[f"{name}_ms"] = _graph_ms(fn, reps)
            times[f"{name}_ms_eager"] = _time_ms(fn, reps)
        times["routing_host_ms"] = _host_ms(lambda i: routing(logits), 500)
        row[f"T{T}"] = times
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose repro_torch is timed")
    ap.add_argument("--compare", type=pathlib.Path, default=None,
                    help="another checkout: run it, here, here, it")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_route needs a CUDA device")
    if a.compare is None:
        rows = [run_one(a.root.resolve())]
    else:
        rows = []
        for root in (a.compare, HERE, HERE, a.compare):
            res = subprocess.run(
                [sys.executable, str(HERE / "profile_route.py"), "--root",
                 str(root.resolve())], capture_output=True, text=True,
                timeout=900)
            if res.returncode != 0:
                raise SystemExit(f"profile_route failed for {root}:\n"
                                 f"{res.stderr[-4000:]}")
            rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
    lines = [json.dumps(r) for r in rows]
    for line in lines:
        print(line, flush=True)
    if a.compare is None:             # a comparison's runs wrote theirs
        OUT.mkdir(exist_ok=True)
        with open(OUT / "profile_route.jsonl", "a") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
