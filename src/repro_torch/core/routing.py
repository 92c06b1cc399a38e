"""Import shim: routing moved to :mod:`repro_torch.control.routing`
when the control plane was unified (see docs/CONTROL.md)."""
from repro_torch.control.routing import (PlanAwareRouter,     # noqa: F401
                                   ThresholdRouter, pick_endpoint,
                                   route_global, route_jsq)
