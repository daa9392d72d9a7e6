"""Serving launcher of the port: ``python -m repro_torch.launch.serve
--arch <id> [--full] [--device cpu]``, twin of ``repro.launch.serve``.

Batched prefill + decode with fixed slots (continuous-batching-lite),
with random weights from ``torch.Generator`` seed 0 and prompts from
numpy seed 0.  Without ``--full`` the reduced config of the arch family
is served.  It runs on the card; ``serve(..., device="cpu")`` runs the
plain versions on the CPU.  Every text-only architecture is served; a
frontend architecture (``paligemma-3b``, ``whisper-base``) raises
``ValueError``, as the reference's server cannot feed it either.

``serve`` drives the server tick by tick and synchronises after each
tick, so that it can report time to first token, decode time per step
and output tokens per second on the device's clock; the synchronise
adds no work to a tick, which ends in host bookkeeping anyway.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import init_params
from repro_torch.serve.server import Request, Server, check_servable


@dataclass
class ServeReport:
    cfg: ArchConfig
    server: Server
    requests: List[Request]
    served: int                       # requests with max_new tokens
    prefills: int
    decode_steps: int
    wall_s: float                     # submit to the last token
    init_s: float = 0.0               # random init, when serve drew it
    init_peak_bytes: int = 0          # the card's peak after that init
    tick_s: List[float] = field(default_factory=list)
    tick_fills: List[int] = field(default_factory=list)
    ttft_s: Dict[int, float] = field(default_factory=dict)   # rid -> s

    def metrics(self) -> Dict[str, float]:
        """TTFT (submit to the end of the tick whose prefill made the
        request's first token; that tick also holds one decode step),
        decode ms per step (median over ticks with no prefill) and output
        tokens per second over the whole drain."""
        ttft = np.array(sorted(self.ttft_s.values())) * 1e3
        pure = [t for t, f in zip(self.tick_s, self.tick_fills) if f == 0]
        n_tok = sum(len(r.out) for r in self.requests)
        return {
            "ttft_ms_first": float(ttft[0]) if len(ttft) else float("nan"),
            "ttft_ms_p50": float(np.percentile(ttft, 50)) if len(ttft)
            else float("nan"),
            "ttft_ms_max": float(ttft[-1]) if len(ttft) else float("nan"),
            "decode_ms_per_step_p50": float(np.median(pure) * 1e3)
            if pure else float("nan"),
            "decode_ms_per_step_p95": float(np.percentile(pure, 95) * 1e3)
            if pure else float("nan"),
            "output_tokens": int(n_tok),
            "output_tokens_per_s": float(n_tok / self.wall_s),
            "wall_s": float(self.wall_s),
        }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, requests: int = 6, prompt_len: int = 16,
          max_new: int = 8, slots: int = 2, full: bool = False,
          device: DeviceLike = None, params=None,
          cfg: Optional[ArchConfig] = None) -> ServeReport:
    """Serve ``requests`` random prompts and return what happened.
    ``params``/``cfg`` override the random weights and the config (the
    tests pass the reference's weights carried across).  When ``serve``
    draws the weights on CUDA, the report's ``init_peak_bytes`` is the
    device's peak allocation after the init: the init's own peak when
    the caller reset the peak statistics just before."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config(arch)
        if not full:
            cfg = cfg.reduced()
    check_servable(cfg)
    init_s, init_peak = 0.0, 0
    if params is None:
        t_init = time.perf_counter()
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen, device=dev)
        _sync(dev)
        init_s = time.perf_counter() - t_init
        if dev.type == "cuda":
            init_peak = torch.cuda.max_memory_allocated(dev)
    srv = Server(cfg, params, max_len=prompt_len + max_new + 8,
                 batch_slots=slots, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        prompt_len).astype(np.int32),
                    max_new=max_new)
            for i in range(requests)]
    _sync(dev)
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    rep = ServeReport(cfg=cfg, server=srv, requests=reqs, served=0,
                      prefills=0, decode_steps=0, wall_s=0.0, init_s=init_s,
                      init_peak_bytes=init_peak)
    seen = set()
    prev = t0
    while srv.queue or any(srv.slots):
        active = srv.step()
        _sync(dev)
        now = time.perf_counter()
        # the requests prefilled in this tick: in a slot now, or (with
        # max_new 1) already finished
        fresh = [r.rid for r in reqs if r.rid not in seen and r.error is None
                 and (r.done or any(s is r for s in srv.slots))]
        seen.update(fresh)
        rep.ttft_s.update((rid, now - t0) for rid in fresh)
        rep.tick_s.append(now - prev)
        rep.tick_fills.append(len(fresh))
        rep.prefills += len(fresh)
        rep.decode_steps += bool(active)
        prev = now
    rep.wall_s = prev - t0
    rep.served = sum(1 for r in reqs if len(r.out) >= max_new)
    return rep


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: cuda; cpu runs the plain versions")
    args = ap.parse_args()
    rep = serve(args.arch, requests=args.requests,
                prompt_len=args.prompt_len, max_new=args.max_new,
                slots=args.slots, full=args.full, device=args.device)
    print(f"served {rep.served}/{len(rep.requests)} requests "
          f"({args.max_new} tokens each, {args.slots} slots)")


if __name__ == "__main__":
    main()
