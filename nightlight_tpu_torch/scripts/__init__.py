"""Microbenchmark entry points of the port (run on a CUDA device)."""
