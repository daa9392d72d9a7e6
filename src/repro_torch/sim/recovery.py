"""Crash-consistent fleet execution: snapshots, a bid-batch WAL and
replay (docs/DESIGN.md §11) — the twin of ``repro.sim.recovery``.

``CrashSafeRunner`` runs the same per-epoch pipeline as
``EpochRunner.epoch`` (policy -> cancel_all -> step -> stats ->
after_step -> advance) and adds two durable artifacts around it:

* a per-epoch **write-ahead log** of the policy output (bids, limits,
  relinquish, sel, bids_clipped), appended and fsynced before the engine
  step consumes it;
* periodic **snapshots** of the whole run state (engine state, fleet
  state, stats counters) through the atomic ``CheckpointManager``.

Recovery contract: a process killed at any phase boundary restores the
latest snapshot and replays the strictly later WAL records — the logged
policy output stands in for a live ``policy`` call
(``Fleet.apply_policy_log`` redoes the one fleet-state change policy
makes), then the same cancel_all / step / stats / after_step / advance
pipeline runs — and continues live from the first unlogged epoch.
Owners, rates, bills, retention and stats come out bit-identical to the
uninterrupted run.

WAL format (append-only, framed; byte-compatible with the reference's)::

    MAGIC b"LCW1" | u32 payload_len | u32 crc32(payload) | payload

where payload is an ``np.savez`` archive of the record's arrays
(``epoch`` int64, ``t`` float64, the policy output in its own dtypes).
The reader walks frames from the start and discards a torn or corrupt
tail; ``resume`` truncates the file back to the last valid frame before
appending.  Snapshots use the reference's keys, so a workdir written by
either implementation resumes in the other.

Crash events come from a ``FaultInjector`` schedule (``kind="crash"``);
the raised :class:`SimulatedCrash` carries the event so a chaos harness
can drop already-fired kills from the schedule it hands the next
process.

The snapshot (a host copy of every leaf) and the WAL append (a host copy
of the policy output) are the two points where an epoch waits for the
device.
"""
from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.market_torch import schema
from repro_torch.market_torch.schema import STAT_KEYS
from repro_torch.sim.epoch import accum_stats

MAGIC = b"LCW1"
_HEADER = struct.Struct("<4sII")      # magic, payload_len, crc32

#: kill-point boundaries, in intra-epoch order: before the WAL append,
#: mid-append (torn frame), after the fsynced append, after the engine
#: step + fleet update, after the snapshot.
PHASES = ("pre_wal", "mid_wal", "post_wal", "post_step",
          "post_snapshot")

_WAL_KEYS = ("price", "limit", "level", "node", "tenant")


class SimulatedCrash(RuntimeError):
    """Raised at a scheduled kill-point after every durable effect of
    the phases already passed is flushed — what the runner left on disk
    is exactly what a ``kill -9`` would leave."""

    def __init__(self, event):
        super().__init__(f"simulated crash at t={event.t} "
                         f"phase={event.phase}")
        self.event = event


class WriteAheadLog:
    """Append-only framed record log with fsync durability."""

    def __init__(self, path: str) -> None:
        self.path = path

    def append(self, record: Dict[str, np.ndarray], *,
               torn_frac: Optional[float] = None) -> None:
        """Frame, append and fsync one record.  ``torn_frac`` simulates
        a crash mid-append: only that fraction of the frame reaches the
        file (still fsynced, so the torn tail is what a real mid-write
        power cut leaves behind)."""
        buf = io.BytesIO()
        np.savez(buf, **record)
        payload = buf.getvalue()
        frame = _HEADER.pack(MAGIC, len(payload),
                             zlib.crc32(payload)) + payload
        if torn_frac is not None:
            frame = frame[:max(1, int(len(frame) * torn_frac))]
        with open(self.path, "ab") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())

    def read_all(self) -> Tuple[List[Dict[str, np.ndarray]], int]:
        """Walk frames from the start; return ``(records, valid_len)``
        where ``valid_len`` is the byte offset of the first torn or
        corrupt frame (== file size when the log is clean)."""
        records: List[Dict[str, np.ndarray]] = []
        if not os.path.exists(self.path):
            return records, 0
        with open(self.path, "rb") as f:
            data = f.read()
        off = 0
        while off + _HEADER.size <= len(data):
            magic, n, crc = _HEADER.unpack_from(data, off)
            end = off + _HEADER.size + n
            if magic != MAGIC or end > len(data):
                break
            payload = data[off + _HEADER.size:end]
            if zlib.crc32(payload) != crc:
                break
            with np.load(io.BytesIO(payload)) as z:
                records.append({k: z[k] for k in z.files})
            off = end
        return records, off

    def truncate_to(self, valid_len: int) -> None:
        if os.path.exists(self.path):
            with open(self.path, "r+b") as f:
                f.truncate(valid_len)
                f.flush()
                os.fsync(f.fileno())


def _ticks(duration_s: float, tick_s: float) -> List[float]:
    """The drive loops' tick sequence, reproduced by the same float
    accumulation (``t += tick_s``) so replayed epochs see bit-equal
    timestamps."""
    out, t = [], 0.0
    while t <= duration_s:
        out.append(t)
        t += tick_s
    return out


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class CrashSafeRunner:
    """Durable fleet runner over one ``(market, fleet, rtype)`` triple.

    ``run`` starts from the market facade's current state; ``resume``
    restores the newest snapshot under ``workdir`` onto the engine's
    device, replays the WAL tail, and continues live.  Both publish the
    final state back onto the facade (``market.states`` / ``now`` /
    ``stats``) like ``EpochRunner.drive`` and return
    ``(fleet_state, host_stats)``."""

    def __init__(self, market, fleet, rtype: str, workdir: str,
                 snapshot_every: int = 1, injector=None) -> None:
        self.market = market
        self.fleet = fleet
        self.rtype = rtype
        self.eng = market.engines[rtype]
        self.device = self.eng.device
        self.workdir = workdir
        self.snapshot_every = max(1, int(snapshot_every))
        self.injector = injector
        os.makedirs(workdir, exist_ok=True)
        # keep enough snapshots that the one we restore always has a
        # complete WAL suffix behind it
        self.ckpt = CheckpointManager(os.path.join(workdir, "snaps"),
                                      keep=4)
        self.wal = WriteAheadLog(os.path.join(workdir, "bids.wal"))

    # ---------------------------------------------------------- plumbing
    @staticmethod
    def _canon(est: dict) -> dict:
        est = dict(est)
        est["floor"] = tuple(est["floor"])
        est["floor_t"] = tuple(est["floor_t"])
        return est

    def _engine_state(self) -> dict:
        return self._canon(self.market.states[self.rtype])

    def _zero_stats(self) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros((), dtype=torch.int32, device=self.device)
                for k in STAT_KEYS}

    def _template(self, params) -> dict:
        return {"eng": self._canon(self.eng.init_state()),
                "fleet": self.fleet.init_state(params),
                "stats": self._zero_stats()}

    def _publish(self, est, t_last: float, stats) -> Dict[str, int]:
        market, rtype = self.market, self.rtype
        market.states[rtype] = est
        market._np[rtype] = None
        market.now = max(market.now, t_last)
        schema.maybe_validate(est, self.eng, where=f"{rtype} state")
        host = {k: int(stats[k]) for k in STAT_KEYS}
        for k in ("orders", "transfers", "explicit_relinquish",
                  "implicit_relinquish", "revoked_by_fault"):
            market.stats[k] += host[k]
        return host

    @staticmethod
    def _wal_record(epoch: int, t: float, bids, limits, relinq, sel,
                    bids_clipped) -> Dict[str, np.ndarray]:
        rec = {"epoch": np.int64(epoch), "t": np.float64(t),
               "limits": _host(limits), "relinq": _host(relinq),
               "sel": _host(sel), "bids_clipped": _host(bids_clipped)}
        for k in _WAL_KEYS:
            rec[f"bid_{k}"] = _host(bids[k])
        return rec

    def _from_log(self, arr: np.ndarray) -> torch.Tensor:
        """A logged array on the engine's device, in its logged dtype."""
        return torch.from_numpy(np.array(arr)).to(self.device)

    def _maybe_crash(self, t: float, phase: str) -> None:
        if self.injector is None:
            return
        ev = self.injector.due_crash(t, phase)
        if ev is not None:
            if ev.phase not in PHASES:
                raise ValueError(f"unknown crash phase {ev.phase!r}")
            raise SimulatedCrash(ev)

    # -------------------------------------------------------------- run
    def run(self, params, duration_s: float, tick_s: float,
            fleet_state=None) -> Tuple[dict, Dict[str, int]]:
        # a fresh run gets fresh durable state: stale snapshots or WAL
        # frames of an earlier run in the same workdir would shadow
        # this run's on a later resume
        if os.path.exists(self.wal.path):
            os.unlink(self.wal.path)
        for s in self.ckpt.all_steps():
            os.unlink(self.ckpt._path(s))
        if fleet_state is None:
            fleet_state = self.fleet.init_state(params)
        return self._drive(params, self._engine_state(), fleet_state,
                           self._zero_stats(), _ticks(duration_s, tick_s),
                           start_epoch=0, records=None)

    def resume(self, params, duration_s: float, tick_s: float
               ) -> Tuple[dict, Dict[str, int]]:
        """Restore the newest snapshot, replay the WAL tail, continue
        live — the recovery path a restarted process takes.  With no
        snapshot on disk yet (death before the first one), the run
        restarts from the market facade's current state, so the caller
        must hand this runner a facade in the dead process's initial
        state (floors seeded from the same configuration)."""
        ticks = _ticks(duration_s, tick_s)
        records, valid_len = self.wal.read_all()
        self.wal.truncate_to(valid_len)      # drop any torn tail frame
        snap = self.ckpt.latest_step()
        if snap is None:
            est = self._engine_state()
            fleet_state = self.fleet.init_state(params)
            stats = self._zero_stats()
            start = 0
        else:
            tree = self.ckpt.restore(snap, self._template(params),
                                     self.device)
            est, fleet_state = tree["eng"], tree["fleet"]
            stats = tree["stats"]
            start = snap + 1
        if self.injector is not None:
            self.injector.rewind_to(ticks[start - 1] if start > 0 else -1.0)
        by_epoch = {int(r["epoch"]): r for r in records}
        return self._drive(params, est, fleet_state, stats, ticks,
                           start_epoch=start, records=by_epoch)

    # ------------------------------------------------------------ epochs
    def _drive(self, params, est, fleet_state, stats, ticks: List[float],
               start_epoch: int, records: Optional[Dict[int, dict]]
               ) -> Tuple[dict, Dict[str, int]]:
        eng, fleet = self.eng, self.fleet
        for e in range(start_epoch, len(ticks)):
            t = ticks[e]
            if self.injector is not None:
                est = self.injector.apply_health(eng, est, t)
            rec = records.get(e) if records is not None else None
            owner_b = est["owner"]
            if rec is not None:
                # replay: the logged policy output stands in for a live
                # policy call (a WAL record means the policy ran)
                bids = {k: self._from_log(rec[f"bid_{k}"])
                        for k in _WAL_KEYS}
                limits = self._from_log(rec["limits"])
                relinq = self._from_log(rec["relinq"])
                sel = self._from_log(rec["sel"])
                clipped = self._from_log(rec["bids_clipped"])
                fleet_state = fleet.apply_policy_log(fleet_state, t,
                                                     owner_b, sel)
            else:
                limits, relinq, sel, bids, fleet_state, info = \
                    fleet.policy(params, fleet_state, t, owner_b,
                                 est["rate"], tuple(est["floor"]))
                clipped = info["bids_clipped"]
                self._maybe_crash(t, "pre_wal")
                torn = self.injector is not None and \
                    self.injector.due_crash(t, "mid_wal")
                self.wal.append(
                    self._wal_record(e, t, bids, limits, relinq, sel,
                                     clipped),
                    torn_frac=0.5 if torn else None)
                if torn:
                    raise SimulatedCrash(torn)
                self._maybe_crash(t, "post_wal")
            est = eng.cancel_all(est)
            est, transfers, _bills = eng.step(est, t, bids, None, relinq,
                                              limits)
            stats = accum_stats(stats, bids, transfers, sel, clipped)
            fleet_state, held = fleet.after_step(
                params, fleet_state, t, owner_b, est["owner"], sel)
            fleet_state = fleet.advance(params, fleet_state, t, held)
            self._maybe_crash(t, "post_step")
            if e % self.snapshot_every == 0:
                self.ckpt.save(e, {"eng": est, "fleet": fleet_state,
                                   "stats": stats})
            self._maybe_crash(t, "post_snapshot")
        return fleet_state, self._publish(est, ticks[-1] if ticks else 0.0,
                                          stats)
