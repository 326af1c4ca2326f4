"""Weights, kernels and apply functions of the PyTorch port."""
