"""Event-loop simulator and vector engine (ports of the ``repro.sim`` modules)."""
