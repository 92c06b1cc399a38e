"""Import shim: the hourly controller moved to
:mod:`repro_torch.control.planner` when the control plane was unified
(see docs/CONTROL.md)."""
from repro_torch.control.planner import (ControllerConfig,    # noqa: F401
                                   SageServeController)
