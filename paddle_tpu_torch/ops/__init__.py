"""Ops of the PyTorch port: plain tensor functions and the hand-written kernels."""
