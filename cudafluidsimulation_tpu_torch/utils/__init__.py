"""Utilities of the PyTorch/CUDA port."""
