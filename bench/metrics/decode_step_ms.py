"""decode_step_ms: the mean wall time of the window's steps that
admitted nothing, each a decode of every slot (ms, host clock; the
traced stretch is not among them)."""


def read(run):
    s = run.window.plain_step_s()
    return s * 1e3 if s is not None else None
