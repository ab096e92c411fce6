"""Output artifacts of the PyTorch port."""
