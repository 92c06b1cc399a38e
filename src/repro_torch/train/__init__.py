"""Training: AdamW, schedules, checkpoints and the loop (port of ``repro.train``)."""
