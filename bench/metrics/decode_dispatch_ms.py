"""decode_dispatch_ms: the mean, over every decode of the window, of its
``serve.decode`` span less the ``serve.sample`` inside it (ms, host
clock, ``repro_torch.tracing``): the host time spent building the
inputs and issuing the decode's kernels and copies, before it waits for
the card.  What a decode step captured in a CUDA graph would save."""
from bench.harness import spans


def read(run):
    sp = spans.of(run.window)
    if sp is None:
        return None
    sample = {s.parent_seq: s for s in sp.named("serve.sample")}
    own = [d.t1 - d.t0 - (sample[d.seq].t1 - sample[d.seq].t0)
           for d in sp.named("serve.decode") if d.seq in sample]
    return sum(own) / len(own) / 1e6 if own else None
