"""Import shim: the ILP solver moved to :mod:`repro_torch.control.ilp`
when the control plane was unified (see docs/CONTROL.md)."""
from repro_torch.control.ilp import ILPResult, solve_ilp      # noqa: F401
