"""fem layer of the PyTorch port."""
