"""Event-loop simulator (verbatim port of the ``repro.sim`` modules).

The vector engine (``repro.sim.vector``) is not ported yet.
"""
