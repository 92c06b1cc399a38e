"""The PyTorch/CUDA port's serving benchmark: one cell a run."""
