"""decode_step_ms.engine: the mean of the engine's own ``serve.decode``
span over every step of the window, admitting steps included (ms, host
clock, ``repro_torch.tracing``): building the slots' inputs, issuing the
decode's kernels and copies, and the sampling's wait for the card.
``decode_step_ms`` is its outside twin, taken around whole steps that
admitted nothing."""
from bench.harness import spans


def read(run):
    sp = spans.of(run.window)
    dec = sp.named("serve.decode") if sp else []
    if not dec:
        return None
    return sum(s.t1 - s.t0 for s in dec) / len(dec) / 1e6
