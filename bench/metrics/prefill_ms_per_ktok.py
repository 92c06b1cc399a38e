"""prefill_ms_per_ktok: the wall time that the window's admitting steps
took beyond a decode step (``decode_step_ms``'s mean), per 1,000 prompt
tokens admitted (ms, host clock): the engine's serial B=1 prefills,
their slot writes and their first tokens."""


def read(run):
    s = run.window.prompt_token_s()
    return s * 1e6 if s is not None else None
