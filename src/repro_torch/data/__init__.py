"""Synthetic training data (port of ``repro.data``)."""
