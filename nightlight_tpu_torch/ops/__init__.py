"""Compute functions on torch tensors: statistics, calibration,
stacking, resampling, pixel math, and the CUDA kernel wrappers."""
