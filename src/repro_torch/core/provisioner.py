"""Import shim: the provisioner moved to :mod:`repro_torch.control.provision`
when the control plane was unified (see docs/CONTROL.md)."""
from repro_torch.control.provision import (ProvisionProblem,  # noqa: F401
                                     ProvisionSolution, solve,
                                     solve_with_routing)
