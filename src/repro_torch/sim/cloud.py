"""The spot market's book, copied from ``repro.sim.cloud`` (``SpotRequest``
and ``SpotBook`` only): the clearing-price / notice / one-shot-request
state machine the fleet-scale spot baseline (``sim/fleet_baselines.py``)
drives.  Host Python, no tensors."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class SpotRequest:
    seq: int
    tenant: str
    bid: float            # frozen at request time, never renegotiated


class SpotBook:
    """Single-resource-type spot market core: launch-bid book, clearing
    price, reclamation notices.  Pure state machine (no Tenant
    callbacks), so a test can drive it directly.

    Semantics:

    * the spot price is the **clearing price of marginal demand**: with
      all standing bids (held leaves at their launch bids + open
      requests) sorted descending over capacity C, the price is the
      highest *rejected* bid, or the reserve ``floor`` when demand fits;
    * a held leaf whose launch bid is under the spot price gets a
      reclamation notice ``notice_s`` ahead; at expiry it is revoked iff
      the price still exceeds its bid (a dip back under the bid rescinds
      the notice) — so preemption fires iff spot > launch bid;
    * winners pay ``min(spot, bid)`` — bills never exceed the bid rate;
    * requests are **one-shot** (AWS one-time spot requests): whatever
      does not fill in a clearing expires at its end, so demand is
      re-quoted at the next step's conditions.  Only *launched*
      instances keep their bid frozen — that frozen launch bid, never
      renegotiated, is the interface difference vs laissez-faire.
    """

    def __init__(self, leaves: Sequence[int], floor: float,
                 notice_s: float = 120.0) -> None:
        self.leaves = list(leaves)
        self.floor = float(floor)
        self.notice_s = float(notice_s)
        self.owner: Dict[int, Optional[str]] = {l: None for l in self.leaves}
        self.launch_bid: Dict[int, float] = {}
        self.notice: Dict[int, float] = {}          # leaf -> deadline
        self.requests: List[SpotRequest] = []
        self.spot = self.floor
        self._seq = 0
        self.stats = {"requests": 0, "grants": 0, "preemptions": 0,
                      "notices": 0, "rescinded": 0, "expired": 0}

    # ------------------------------------------------------------- intake
    def request(self, tenant: str, bid: float) -> None:
        self.requests.append(SpotRequest(self._seq, tenant, float(bid)))
        self._seq += 1
        self.stats["requests"] += 1

    def cancel_newest(self, tenant: str, k: int) -> int:
        """Drop the tenant's k most recent open requests (demand fell)."""
        dropped = 0
        for i in range(len(self.requests) - 1, -1, -1):
            if dropped >= k:
                break
            if self.requests[i].tenant == tenant:
                del self.requests[i]
                dropped += 1
        return dropped

    def release(self, leaf: int) -> None:
        """Voluntary release by the holder."""
        self.owner[leaf] = None
        self.launch_bid.pop(leaf, None)
        self.notice.pop(leaf, None)

    def held(self, tenant: str) -> List[int]:
        return [l for l, o in self.owner.items() if o == tenant]

    def open_requests(self, tenant: str) -> int:
        return sum(1 for r in self.requests if r.tenant == tenant)

    # ----------------------------------------------------------- clearing
    def clear(self, now: float
              ) -> Tuple[List[Tuple[str, int, float]],
                         List[Tuple[str, int]]]:
        """One market step at ``now``: recompute the spot price, issue /
        rescind / fire reclamation notices, grant free leaves to winning
        requests.  Returns ``(grants, preempts)`` as
        ``[(tenant, leaf, bid)]`` / ``[(tenant, leaf)]``."""
        C = len(self.leaves)
        bids = sorted(
            [self.launch_bid[l] for l, o in self.owner.items()
             if o is not None] + [r.bid for r in self.requests],
            reverse=True)
        self.spot = max(self.floor, bids[C]) if len(bids) > C \
            else self.floor
        # notices: issue where the price overtook the launch bid, rescind
        # where it receded
        for leaf, own in self.owner.items():
            if own is None:
                continue
            if self.launch_bid[leaf] < self.spot - 1e-9:
                if leaf not in self.notice:
                    self.notice[leaf] = now + self.notice_s
                    self.stats["notices"] += 1
            elif self.notice.pop(leaf, None) is not None:
                self.stats["rescinded"] += 1
        preempts: List[Tuple[str, int]] = []
        for leaf, deadline in sorted(self.notice.items()):
            if deadline <= now:
                preempts.append((self.owner[leaf], leaf))
                self.owner[leaf] = None
                self.launch_bid.pop(leaf, None)
                del self.notice[leaf]
                self.stats["preemptions"] += 1
        # grants: highest bid first (ties by arrival seq) onto free leaves;
        # a request only clears at or above the current spot price
        free = sorted(l for l, o in self.owner.items() if o is None)
        grants: List[Tuple[str, int, float]] = []
        for r in sorted(self.requests, key=lambda r: (-r.bid, r.seq)):
            if not free:
                break
            if r.bid < self.spot - 1e-9 or r.bid < self.floor - 1e-9:
                continue
            leaf = free.pop(0)
            self.owner[leaf] = r.tenant
            self.launch_bid[leaf] = r.bid
            self.requests.remove(r)
            grants.append((r.tenant, leaf, r.bid))
            self.stats["grants"] += 1
        # one-shot requests: anything unfilled expires now.  A stale
        # frozen bid must not linger — it blocks the requester from
        # re-quoting at next step's urgency/price (observed as alone-run
        # starvation: a sub-floor bid pinned ``pending`` forever).
        self.stats["expired"] += len(self.requests)
        self.requests.clear()
        return grants, preempts

    def bill_rate(self, leaf: int) -> float:
        """Current $/h for a held leaf: the uniform clearing price,
        capped at the holder's launch bid."""
        return min(self.spot, self.launch_bid.get(leaf, self.spot))
