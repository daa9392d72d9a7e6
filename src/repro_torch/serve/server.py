"""Batched serving loop of the port, twin of ``repro.serve.server``:
prefill + decode with fixed batch slots (continuous-batching-lite) and
the same admission control (bounded queue, idempotency-key dedup,
bounded retry with backoff and jitter, tick-based timeout).

A request = prompt token array + max_new_tokens.  The server keeps B
decode slots; finished slots are refilled from the queue each step
(prefill for one request at a time, decode for the whole batch).  As in
the reference, every active slot decodes at one shared position, the
largest of the slots' positions, and writes its K/V there.

Decode state stays on the device: next-token ids feed back into the
next decode step without a host round trip, and emitted tokens collect
in ``_out_buf``; the one device-to-host read happens when a request
finishes (``_finish_slot``).  The KV cache is spliced and updated in
place.

A request carries tokens only, as in the reference, whose ``Server``
passes only ``tokens`` to ``prefill``.  A frontend architecture
(``vision_stub`` patches, ``audio_stub`` frames) needs more than that,
so ``Server`` refuses it with a ``ValueError``; drive such a model
through ``models.model.prefill`` and ``decode_step``.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M


class ServeError(Exception):
    """Base of the typed ingest errors; ``kind`` is the wire tag."""
    kind = "serve_error"


class QueueFull(ServeError):
    kind = "queue_full"


class RequestTimeout(ServeError):
    kind = "timeout"


class RetriesExhausted(ServeError):
    kind = "retries_exhausted"

    def __init__(self, msg: str, attempts: int,
                 backoffs: List[float]) -> None:
        super().__init__(msg)
        self.attempts = attempts
        self.backoffs = backoffs


@dataclass
class IngestConfig:
    """Admission-control knobs for `Server.submit`: bounded queue with a
    typed reject, idempotency-key dedup over a sliding window, bounded
    retry with exponential backoff + jitter, and a tick-based total-age
    timeout."""
    max_queue: int = 64             # 0 = unbounded
    dedup_window: int = 256         # idempotency keys remembered
    max_retries: int = 4
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter_frac: float = 0.2        # +/- fraction of the backoff
    timeout_ticks: int = 0          # 0 = no timeout; else max server
    # ticks from submit to completion before RequestTimeout


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[ServeError] = None
    _submit_tick: int = -1


def check_servable(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for an architecture whose input is more than
    tokens (a request holds a prompt only)."""
    if cfg.frontend:
        raise ValueError(
            f"{cfg.name} needs its {cfg.frontend!r} frontend's embeddings "
            "beside the tokens, and a Server request carries tokens only; "
            "drive it through models.model.prefill and decode_step")


class Server:
    def __init__(self, cfg: ArchConfig, params: Any, *, max_len: int = 256,
                 batch_slots: int = 4,
                 ingest: Optional[IngestConfig] = None,
                 device: DeviceLike = None) -> None:
        check_servable(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.B = batch_slots
        self.ingest = ingest or IngestConfig()
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int32)
        self.cache = None
        self.tick_no = 0
        # idempotency key -> Request, insertion-ordered for window
        # eviction; a remembered key resolves to the ORIGINAL request
        self._dedup: "collections.OrderedDict[str, Request]" = \
            collections.OrderedDict()
        self._done_log: List[Request] = []
        dev = self.device
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                  device=dev)
        self._out_buf = torch.zeros((batch_slots, max_len),
                                    dtype=torch.int32, device=dev)
        self._n_out = np.zeros(batch_slots, np.int32)   # host counters
        self._rows = torch.arange(batch_slots, device=dev)
        self.last_logits: Optional[torch.Tensor] = None  # newest decode's

    def submit(self, req: Request,
               idempotency_key: Optional[str] = None) -> Request:
        """Admit a request.  A repeated ``idempotency_key`` inside the
        dedup window returns the original request (completed or not)
        without enqueueing; a full queue raises the typed `QueueFull`."""
        if idempotency_key is not None:
            prior = self._dedup.get(idempotency_key)
            if prior is not None:
                return prior
        if self.ingest.max_queue and \
                len(self.queue) >= self.ingest.max_queue:
            raise QueueFull(
                f"queue at capacity {self.ingest.max_queue}")
        req._submit_tick = self.tick_no
        self.queue.append(req)
        if idempotency_key is not None:
            self._dedup[idempotency_key] = req
            while len(self._dedup) > self.ingest.dedup_window:
                self._dedup.popitem(last=False)
        return req

    def submit_with_retry(self, req: Request,
                          idempotency_key: Optional[str] = None,
                          rng: Optional[np.random.Generator] = None,
                          sleep: Callable[[float], None] = time.sleep
                          ) -> Request:
        """Bounded retry around `submit`: on `QueueFull`, back off
        exponentially (base * 2^attempt, capped) with +/- jitter, then
        retry — at most ``max_retries`` times before the typed
        `RetriesExhausted`.  ``sleep`` is a hook (simulations run server
        ticks instead of waiting); ``rng`` defaults to a generator seeded
        from the rid, so the jitter sequence is reproducible."""
        ig = self.ingest
        rng = rng or np.random.default_rng(req.rid)
        backoffs: List[float] = []
        for attempt in range(ig.max_retries + 1):
            try:
                return self.submit(req, idempotency_key)
            except QueueFull as e:
                if attempt == ig.max_retries:
                    raise RetriesExhausted(
                        f"gave up after {attempt} retries: {e}",
                        attempts=attempt, backoffs=backoffs) from e
                b = min(ig.backoff_cap_s,
                        ig.backoff_base_s * (2.0 ** attempt))
                b *= 1.0 + ig.jitter_frac * (2.0 * rng.random() - 1.0)
                backoffs.append(b)
                sleep(b)
        raise AssertionError("unreachable")

    # ------------------------------------------------------------------
    def _blank_cache(self):
        specs = M.cache_specs(self.cfg, self.B, self.max_len)
        return {key: [{kk: torch.zeros(shape, dtype=dt, device=self.device)
                       for kk, (shape, dt) in e.items()} for e in entries]
                for key, entries in specs.items()}

    def _fill_slot(self, i: int, req: Request) -> None:
        """Prefill one request and splice its cache into slot i."""
        S = len(req.prompt)
        tokens = torch.from_numpy(
            np.asarray(req.prompt, np.int32)[None, :]).to(self.device)
        logits, cache1 = M.prefill(self.params, self.cfg,
                                   {"tokens": tokens}, max_len=self.max_len)
        if self.cache is None:
            self.cache = self._blank_cache()
        # head/tail entries (B, ...); blocks entries (n_super, B, ...)
        for key in ("head", "blocks", "tail"):
            for full_e, one_e in zip(self.cache[key], cache1[key]):
                for kk in full_e:
                    if key == "blocks":
                        full_e[kk][:, i] = one_e[kk][:, 0]
                    else:
                        full_e[kk][i] = one_e[kk][0]
        self.slots[i] = req
        self.pos[i] = S
        # the first sampled token stays on the device too
        nxt = torch.argmax(logits[0, -1]).to(torch.int32)
        self.tokens[i, 0] = nxt
        self._out_buf[i, 0] = nxt
        self._n_out[i] = 1

    def _decode(self, pos: int) -> None:
        logits, self.cache = M.decode_step(self.params, self.cfg,
                                           self.cache, self.tokens, pos)
        self.last_logits = logits
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        n_out = torch.from_numpy(self._n_out.astype(np.int64)).to(
            self.device)
        self._out_buf[self._rows, n_out] = nxt
        self.tokens = nxt[:, None]

    def _finish_slot(self, i: int) -> None:
        """THE device-to-host read: one transfer per completed request,
        copying its accumulated output tokens off the device."""
        req = self.slots[i]
        req.out.extend(
            self._out_buf[i, :int(self._n_out[i])].cpu().numpy().tolist())
        req.done = True
        self.slots[i] = None
        self._n_out[i] = 0
        self._done_log.append(req)

    def _expire(self) -> None:
        """Fail every request older than ``timeout_ticks`` with the typed
        `RequestTimeout` — queued requests are dropped outright,
        in-flight ones keep their partial output."""
        tt = self.ingest.timeout_ticks
        if not tt:
            return
        live = collections.deque()
        for req in self.queue:
            if self.tick_no - req._submit_tick >= tt:
                req.error = RequestTimeout(
                    f"req {req.rid}: queued past {tt} ticks")
                req.done = True
                self._done_log.append(req)
            else:
                live.append(req)
        self.queue = live
        for i in range(self.B):
            req = self.slots[i]
            if req is not None and \
                    self.tick_no - req._submit_tick >= tt:
                self._finish_slot(i)      # keeps partial tokens
                req.error = RequestTimeout(
                    f"req {req.rid}: exceeded {tt} ticks mid-decode")

    def step(self) -> int:
        """One server tick: refill slots, one decode step.  Returns the
        number of active slots.  Sampling runs on the device and
        next-token ids feed back device to device; completion
        bookkeeping uses host-side counters only."""
        self.tick_no += 1
        self._expire()
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                self._fill_slot(i, self.queue.popleft())
        active = [i for i in range(self.B) if self.slots[i] is not None]
        if not active:
            return 0
        # one shared position for every active slot, as the reference
        pos_val = int(max(self.pos[i] for i in active))
        self._decode(pos_val)
        for i in active:
            req = self.slots[i]
            self.pos[i] += 1
            self._n_out[i] += 1
            if int(self._n_out[i]) >= req.max_new \
                    or self.pos[i] >= self.max_len - 1:
                self._finish_slot(i)
        return len(active)

    def drain(self, max_ticks: int = 1000) -> List[Request]:
        """Step until idle; returns the requests that finished during
        this drain (including ones failed by the timeout)."""
        n0 = len(self._done_log)
        ticks = 0
        while (self.queue or any(self.slots)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self._done_log[n0:]
