"""Attention kernels: hand-written CUDA for Hopper, plain PyTorch versions beside them."""
