"""Market constants the batch engine needs, copied from
``repro.core.market`` (the event-driven reference engine stays there)."""
from __future__ import annotations

from dataclasses import dataclass

OPERATOR = "__operator__"


@dataclass
class VolatilityControls:
    max_bid_multiple: float = 0.0     # 0 = disabled
    floor_fall_rate: float = 0.0      # max fractional floor drop per hour
    min_holding_s: float = 0.0
