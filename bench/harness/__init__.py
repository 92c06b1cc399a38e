"""The harness: traffic, weights, the serving loop, the trace and the check."""
