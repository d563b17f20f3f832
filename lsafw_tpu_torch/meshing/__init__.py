"""meshing layer of the PyTorch port."""
