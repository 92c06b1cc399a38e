"""Typed simulator events + hook bus.

The event core knows nothing about policies: it pops ``(time, seq,
event)`` off a heap and publishes each event on the bus.  Cluster
mechanics (arrivals, prefill/decode completion, provisioning) and
policy adapters (tick → ``Scaler.on_tick``, hour → ``GlobalPlanner``)
are just subscribers, so new control-plane behaviour hooks in without
editing the loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Type


@dataclasses.dataclass(eq=False, slots=True)
class Event:
    """Base simulator event (heap ordering is by time, never by event)."""


@dataclasses.dataclass(eq=False, slots=True)
class Arrival(Event):
    request: object


@dataclasses.dataclass(eq=False, slots=True)
class Retry(Event):
    request: object
    attempt: int = 1


@dataclasses.dataclass(eq=False, slots=True)
class PrefillDone(Event):
    instance: object


@dataclasses.dataclass(eq=False, slots=True)
class DecodeDone(Event):
    instance: object
    request: object


@dataclasses.dataclass(eq=False, slots=True)
class InstanceReady(Event):
    pending: object


@dataclasses.dataclass(eq=False, slots=True)
class Tick(Event):
    """Periodic control-plane tick (scaling, QM signals, sampling)."""


@dataclasses.dataclass(eq=False, slots=True)
class Hour(Event):
    """Hourly planning boundary (forecast + ILP)."""


@dataclasses.dataclass(eq=False, slots=True)
class PlacementEffective(Event):
    """A staged model-placement action reaching its ``effective_at``:
    the cluster deploys (weights live, endpoint accepts instances) or
    undeploys (drain-then-retag) the (model, region) pair."""

    action: object          # repro_torch.api.plan.PlacementAction


@dataclasses.dataclass(eq=False, slots=True)
class OutageStart(Event):
    """A scenario region outage begins: instances fail, acquisitions
    are refused until the matching ``OutageEnd``."""

    region: str


@dataclasses.dataclass(eq=False, slots=True)
class OutageEnd(Event):
    region: str


# Control events keep firing while work is in flight but must not extend
# the simulation past its horizon on their own.
CONTROL_EVENTS = (Tick, Hour, PlacementEffective, OutageStart, OutageEnd)
# Exact-class set for the hot loop (isinstance is ~4x slower); derived,
# so new control event types only need adding to CONTROL_EVENTS.
CONTROL_EVENT_SET = frozenset(CONTROL_EVENTS)


class HookBus:
    """Exact-type event dispatch: handlers subscribe per event class and
    run in subscription order."""

    def __init__(self):
        self._handlers: Dict[Type[Event], List[Callable]] = {}

    def subscribe(self, etype: Type[Event], handler: Callable) -> None:
        self._handlers.setdefault(etype, []).append(handler)

    def handlers_for(self, etype: Type[Event]) -> List[Callable]:
        return self._handlers.get(etype, [])

    def publish(self, event: Event) -> None:
        for handler in self._handlers.get(type(event), ()):
            handler(event)
