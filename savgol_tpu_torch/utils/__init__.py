"""Timing utilities of the PyTorch port."""
