"""Models of the PyTorch/CUDA port."""
