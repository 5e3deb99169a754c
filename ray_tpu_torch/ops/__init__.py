"""Attention ops of the port: plain PyTorch versions and the wrappers
of the hand-written Hopper kernels (ops/csrc/)."""
