"""nn/conf of the PyTorch port."""
