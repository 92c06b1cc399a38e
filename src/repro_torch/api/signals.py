"""Observability signals fed to policies via ``Scaler.observe``.

Signals replace policy-specific side channels (Chiron's ``note_backlog``
was a concrete-type special case inside the simulator): the control
plane publishes what it measures, and any policy that cares consumes it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Signal:
    """Base class for control-plane observations."""


@dataclasses.dataclass(frozen=True)
class BacklogSignal(Signal):
    """Queued NIW tokens attributed to one (model, region) endpoint."""

    model: str
    region: str
    tokens: float


@dataclasses.dataclass(frozen=True)
class UtilizationSignal(Signal):
    """Sampled effective-memory utilization of one endpoint."""

    model: str
    region: str
    pool: str
    util: float
    live_instances: int
