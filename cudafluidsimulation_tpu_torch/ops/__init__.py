"""Ops of the PyTorch/CUDA port."""
