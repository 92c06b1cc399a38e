"""decode_graph_share: the share (%) of the window's ``serve.decode``
spans that hold a ``serve.replay``, the engine's launch of its decode's
CUDA graph (host clock, ``repro_torch.tracing``): 100 where every decode
of the window was one graph launch, less where decodes ran op by op.

It reads nothing where the program does not capture its decode: no
``serve.capture`` in the ring and no ``serve.replay`` in the window (a
program that keeps these spans captures once, before the window)."""
from bench.harness import spans


def read(run):
    sp = spans.of(run.window)
    dec = sp.named("serve.decode") if sp else []
    if not dec:
        return None
    replayed = {s.parent_seq for s in sp.named("serve.replay")}
    if not replayed:
        from repro_torch import tracing
        if not any(s.name == "serve.capture" for s in tracing.spans()):
            return None
    return 100.0 * sum(d.seq in replayed for d in dec) / len(dec)
