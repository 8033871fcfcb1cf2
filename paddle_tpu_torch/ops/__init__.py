"""Ops of the PyTorch port: the tensor functions behind ``paddle.*`` (torch
functions on torch tensors, with the JAX package's names and dtype rules),
``nn_ops`` and the hand-written kernels."""
