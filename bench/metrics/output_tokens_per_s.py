"""output_tokens_per_s: every output token made visible inside the
window, over the window's seconds (first step start to last step
return), on the host clock."""
from bench.harness.stats import rate


def read(run):
    w = run.window
    return rate(w.tokens(), w.t_end - w.t0)
