"""Scheme registry and the lifting oracle in PyTorch (2-D slice)."""
