"""Dollar-cost accounting for the serving fleet (§7.2.1).

The paper reports results in GPU-hours *and* dollars (α = $98.32/h per
H100 VM, 25% savings ≈ $2.5M/month).  ``CostModel`` maps a model (a
proxy for its GPU type / VM SKU) to an hourly rate; the cluster accrues
instance-seconds per (model, region) and ``Report`` converts them with
the stack's cost model, so every simulation run prints comparable
``gpu_dollars`` / ``wasted_dollars`` next to instance-hours.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

Key = Tuple[str, str]

#: Paper §7.2.1: hourly price of one H100 serving VM.
DEFAULT_DOLLARS_PER_HOUR = 98.32


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-instance hourly price: flat ``alpha`` with optional per-model
    (i.e. per GPU-type / VM-SKU) overrides."""

    alpha: float = DEFAULT_DOLLARS_PER_HOUR
    rates: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def rate(self, model: str) -> float:
        return float(self.rates.get(model, self.alpha))

    def dollars(self, hours_by_key: Mapping[Key, float]) -> Dict[Key, float]:
        """Convert {(model, region): hours} into dollars."""
        return {(m, r): h * self.rate(m)
                for (m, r), h in hours_by_key.items()}

    def to_dict(self) -> Dict:
        return {"alpha": self.alpha, "rates": dict(self.rates)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "CostModel":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise KeyError(
                f"CostModel.from_dict: unknown keys {sorted(unknown)}")
        return cls(alpha=float(d.get("alpha", DEFAULT_DOLLARS_PER_HOUR)),
                   rates=dict(d.get("rates", {})))
