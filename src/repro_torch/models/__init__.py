"""Models of the PyTorch port, built from the kernel registry."""
