"""nightlight_tpu_torch: the stack path of nightlight_tpu in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A module-for-module port of the JAX package ``nightlight_tpu`` (which stays
the reference the port is held against): FITS ingest, calibration,
bad-pixel repair, robust statistics, star detection, triangle alignment,
the shift-blend warp, clip stacking with goal-seeked sigmas, and FITS/
TIFF/JPEG export, driven by the same CLI flags and JSON job format. The
package imports torch and numpy only; tensors live on an explicit device
(cuda:0 when present) and the clip-stacking and patch-gather kernels are
CUDA C++ under ``csrc/``, built at first use (kernels.py).
"""

__version__ = "0.1.0"
