"""train of the PyTorch port: listeners."""
