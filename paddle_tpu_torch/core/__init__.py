"""Core of the PyTorch port: flags, places, dtypes, random state, the
``Tensor`` cell and op application with Paddle's autograd semantics."""
