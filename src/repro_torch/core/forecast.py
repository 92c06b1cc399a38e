"""Import shim: the forecaster moved to :mod:`repro_torch.control.forecast`
when the control plane was unified (see docs/CONTROL.md)."""
from repro_torch.control.forecast import (ARIMAForecaster,          # noqa: F401
                                    BatchForecastEngine, _css_residuals,
                                    _fit_arma, select_order)
