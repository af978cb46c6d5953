"""Build, load and count the hand-written CUDA kernels.

The kernel sources live in ``nightlight_tpu_torch/csrc``. At first use they
are compiled with ``nvcc`` for Hopper (``sm_90a``) into ONE shared library
with a plain C interface, which is loaded with ``ctypes``. The library goes
to ``build/kernels/<hash of the sources>/`` inside the checkout (listed in
.gitignore), so an edited source rebuilds and an unchanged one is reused
within a checkout.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``. A wrapper only asks for the library when
it is handed a CUDA tensor, and a build or launch failure raises.

Every wrapper counts its launches here (``count_launch``), so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("stack_clip.cu", "stack_linfit.cu", "gather_patches.cu")
HEADERS = ("common.cuh",)
# -fmad=false: no contraction of a*b+c into one rounding, so the kernels
# round like the plain PyTorch versions they are checked against
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches counted by its wrapper
KERNEL_NAMES = ("stack_clip", "stack_linfit", "gather_patches")
_launches = {name: 0 for name in KERNEL_NAMES}

_lib = None
_lib_lock = threading.Lock()
BUILD_INFO: dict = {}


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernel library if this source hash has no build yet.
    Returns the path of the shared library; records the build time and the
    ptxas report in BUILD_INFO."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libnightlight_kernels.so"
    if lib_path.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("cached", True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    (out_dir / "ptxas.txt").write_text(proc.stderr)
    BUILD_INFO.update(seconds=seconds, cached=False, ptxas=proc.stderr)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_float)
            lib.nl_stack_clip.argtypes = [vp, vp, i32, i64, i64, f32, f32, f32, i32,
                                          vp, vp, vp, vp]
            lib.nl_stack_clip.restype = i32
            lib.nl_stack_linfit.argtypes = [vp, i32, i64, i64, f32, f32, f32,
                                            vp, vp, vp, vp, vp]
            lib.nl_stack_linfit.restype = i32
            lib.nl_gather_patches.argtypes = [vp, i32, i32, vp, vp, i32, i32,
                                              vp, vp]
            lib.nl_gather_patches.restype = i32
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index not in (None, 0):
        # the library's own CUDA runtime launches on its current device, 0
        raise ValueError(f"{name}: the kernels run on cuda:0, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
