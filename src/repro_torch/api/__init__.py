"""Component registry (port of ``repro.api.registry``)."""
