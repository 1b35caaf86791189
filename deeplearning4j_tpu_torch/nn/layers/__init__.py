"""nn/layers of the PyTorch port."""
