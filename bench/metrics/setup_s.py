"""setup_s: process start to the window's start (s), on the host clock:
imports, kernel builds, weights, the cache, filling the slots and the
warm-up steps."""


def read(run):
    return run.setup_s
