"""Host utilities of the PyTorch port: the Strouhal number and timers."""
