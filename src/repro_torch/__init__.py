"""PyTorch/CUDA port of the DDSL device engine."""
