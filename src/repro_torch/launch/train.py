"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [...]``, twin of ``repro.launch.train``.

Without ``--full`` it trains the reduced config of the arch family.  The
``--market`` flag attaches a LaissezCloud broker over the port's
``core.market.Market`` (one H100 leaf per rank of the default group),
so the job is elastic under renegotiation.  ``main`` runs on the card
on every rank of the default group (one rank, made on the fly, when
there is none); ``train`` is the same run as a function, with the
device and the optimizer the caller picks.  ``market_scenario`` is the
reference's market-driven elastic scenario
(``tests/test_system.py``): a rival outbids the tenant for one of its
two leaves, then leaves, and the tenant trains through both.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.market import Market
from repro_torch.core.topology import build_cluster
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import DeviceLike
from repro_torch.launch.mesh import ensure_default_group
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import (MarketBroker, ResourceBroker,
                                       TrainConfig, Trainer, TrainReport)

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_train_ckpt")


def train(arch: str, *, steps: int = 100, seq_len: int = 128,
          global_batch: int = 4, full: bool = False,
          ckpt_dir: str = CKPT_DIR, lr: float = 3e-4, market: bool = False,
          opt: Optional[AdamWConfig] = None,
          checkpoint_every: Optional[int] = None,
          device: DeviceLike = None) -> Tuple[Trainer, TrainReport]:
    """``main``'s run: ``opt`` defaults to ``AdamWConfig(lr=lr)`` and
    ``checkpoint_every`` to a quarter of the steps, as ``main`` sets
    them.  Returns the trainer (its final state) and its report."""
    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=0)
    every = checkpoint_every or max(steps // 4, 1)
    tcfg = TrainConfig(steps=steps, checkpoint_every=every,
                       checkpoint_dir=ckpt_dir)
    ensure_default_group(device)
    n = dist.get_world_size()
    if market:
        topo = build_cluster({"H100": n}, gpus_per_host=min(n, 8))
        mkt = Market(topo)
        mkt.set_floor(topo.roots["H100"], 2.0)
        for _ in range(n):
            mkt.place_order("trainer", topo.roots["H100"], 3.0, limit=4.0)
        broker = MarketBroker(mkt, "trainer", max_devices=n)
    else:
        broker = ResourceBroker(n)
    tr = Trainer(cfg, dcfg, opt or AdamWConfig(lr=lr), tcfg, broker,
                 device=device)
    return tr, tr.run()


def market_scenario(cfg: ArchConfig, dcfg: DataConfig, opt: AdamWConfig,
                    ckpt_dir: str, max_devices: int,
                    device: DeviceLike = None,
                    after_run: Optional[Callable[[int], None]] = None
                    ) -> Tuple[List[TrainReport], Dict[str, float]]:
    """Two tenants, two H100 leaves and no idle supply.  "trainA" holds
    both and trains 8 steps; a rival outbids it for one (its grant falls
    to 1) and it resumes to step 16; the rival leaves, trainA re-bids,
    holds 2 again and resumes to step 24.  A checkpoint every 8 steps;
    the first run resumes from ``ckpt_dir``'s latest checkpoint when
    there is one.  ``after_run(i)`` is called after run ``i`` (0, 1, 2)
    has written its checkpoint.  Returns the three runs' reports and the
    bills settled at t = 300 s."""
    topo = build_cluster({"H100": 2}, gpus_per_host=2, hosts_per_rack=1,
                         racks_per_zone=1)
    market = Market(topo)
    root = topo.roots["H100"]
    market.set_floor(root, 2.0)
    for _ in range(2):
        market.place_order("trainA", root, 3.0, limit=3.5)
    tc = TrainConfig(steps=8, checkpoint_every=8, checkpoint_dir=ckpt_dir)
    tr = Trainer(cfg, dcfg, opt, tc,
                 MarketBroker(market, "trainA", max_devices), device=device)
    reps = []

    def run() -> None:
        reps.append(tr.run(resume=True))
        if after_run is not None:
            after_run(len(reps) - 1)
    run()
    market.advance_to(100.0)                      # the rival outbids
    market.place_order("rival", root, 4.0, limit=9.0)
    tc.steps = 16
    run()
    market.advance_to(200.0)                      # the rival leaves
    for leaf in list(market.owned_leaves("rival")):
        market.relinquish("rival", leaf)
    market.place_order("trainA", root, 3.0, limit=3.5)
    tc.steps = 24
    run()
    return reps, market.settle(300.0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="use the full config instead of the reduced "
                         "smoke config")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--market", action="store_true",
                    help="allocate devices through a local LaissezCloud "
                         "market (elastic)")
    args = ap.parse_args()
    _, rep = train(args.arch, steps=args.steps, seq_len=args.seq_len,
                   global_batch=args.global_batch, full=args.full,
                   ckpt_dir=args.ckpt_dir, lr=args.lr, market=args.market)
    print(f"steps={rep.steps_done} loss {rep.losses[0]:.4f} -> "
          f"{rep.losses[-1]:.4f} resizes={rep.resizes} "
          f"stragglers={rep.stragglers}")


if __name__ == "__main__":
    main()
