"""Instance-level scheduling policies (port of ``repro.core.scheduling``)."""
