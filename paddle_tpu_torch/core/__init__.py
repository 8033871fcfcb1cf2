"""Core: flags, places, random state and dtypes of the PyTorch port."""
