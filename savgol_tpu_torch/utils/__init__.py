"""Utilities of the PyTorch port: device timing, profiling, the card's
cost model (the kernels' bounds) and the coefficient exporter."""
