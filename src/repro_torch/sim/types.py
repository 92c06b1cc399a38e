"""Shared simulator datatypes."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

TIER_IWF = "IW-F"
TIER_IWN = "IW-N"
TIER_NIW = "NIW"

# SLA targets (paper §2.2): IW-F TTFT < 1 s, IW-N TTFT < 60 s @ P95;
# NIW: 24 h batch deadline.
TTFT_SLA = {TIER_IWF: 1.0, TIER_IWN: 60.0}
NIW_DEADLINE = 24 * 3600.0


@dataclasses.dataclass(slots=True)
class Request:
    rid: int
    model: str
    region: str                  # origin region (routing preference)
    tier: str
    arrival: float
    prompt_tokens: int
    output_tokens: int
    ttft_deadline: float         # absolute
    deadline: float              # absolute E2E / batch deadline
    priority: int = 1            # NIW only; 0 once promoted

    # outcomes -------------------------------------------------------------
    served_region: Optional[str] = None
    instance: Optional[str] = None
    admitted: float = math.nan
    ttft: float = math.nan       # seconds
    e2e: float = math.nan        # seconds

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.output_tokens

    def ttft_ok(self) -> bool:
        sla = TTFT_SLA.get(self.tier)
        if sla is None:
            return True
        return (not math.isnan(self.ttft)) and self.ttft <= sla

    def deadline_ok(self, tol: float = 0.0) -> bool:
        if math.isnan(self.e2e):
            return False
        return self.arrival + self.e2e <= self.deadline + tol
