"""Build, load and count the hand-written CUDA kernels.

The kernel sources live in ``nightlight_tpu_torch/csrc``. At first use each
is compiled with its own ``nvcc`` for Hopper (``sm_90a``), all of them at
once, and the objects are linked into ONE shared library with a plain C
interface, which is loaded with ``ctypes``. The library goes to
``build/kernels/<hash of the sources>/`` inside the checkout (listed in
.gitignore), so an edited source rebuilds and an unchanged one is reused
within a checkout.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``. A wrapper only asks for the library when
it is handed a CUDA tensor, and a build or launch failure raises.

Every wrapper counts its launches here (``count_launch``), so a run can show
that its main path went through the kernels; the counts are per kernel,
summed over every card and thread.

Every C entry that launches takes the ordinal of the card its tensors lie
on and PyTorch's current stream of that card (``launch_on``), so the
kernels run on any ``cuda:k``: a device mesh (parallel/mesh.py) launches
each shard's kernel on its own card.
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

from nightlight_tpu_torch import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("stack_clip.cu", "stack_linfit.cu", "stack_single_pass.cu", "gather_patches.cu",
           "sort_sum.cu", "warp_shift.cu", "detect_finish.cu")
HEADERS = ("common.cuh", "sortnet.cuh", "single_pass.cuh", "bulk_ring.cuh", "warp_shift.cuh",
           "detect_finish.cuh")
# -fmad=false: no contraction of a*b+c into one rounding, so the kernels
# round like the plain PyTorch versions they are checked against
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches counted by its wrapper
KERNEL_NAMES = ("stack_clip", "stack_linfit", "stack_single_pass", "gather_patches",
                "sort_sum", "warp_shift", "detect_finish")
_launches = {name: 0 for name in KERNEL_NAMES}

# a served job launches from a request handler's thread
_count_lock = threading.Lock()

_lib = None
_lib_lock = threading.Lock()
BUILD_INFO: dict = {}


def count_launch(name: str) -> None:
    with _count_lock:
        _launches[name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def launch_counts() -> dict:
    with _count_lock:
        return dict(_launches)


trace.source("kernels.launches", launch_counts)


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
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [out_dir / f".{Path(s).stem}.{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                               str(CSRC / s)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(SOURCES, objs)]
    reports, failed = [], []
    for s, proc in zip(SOURCES, procs):
        _, err = proc.communicate()
        reports.append(f"== {s}\n{err}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {s} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f".lib.{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib_path)
    for o in objs:
        o.unlink()
    ptxas = "".join(reports)
    (out_dir / "ptxas.txt").write_text(ptxas)
    BUILD_INFO.update(seconds=seconds, cached=False, ptxas=ptxas)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_float)
            # every launching entry ends in (device ordinal, stream)
            lib.nl_stack_clip.argtypes = [vp, vp, i32, i64, i64, f32, f32, f32, i32,
                                          vp, vp, vp, i32, vp]
            lib.nl_stack_clip.restype = i32
            lib.nl_stack_linfit.argtypes = [vp, i32, i64, i64, f32, f32, f32,
                                            vp, vp, vp, vp, i32, vp]
            lib.nl_stack_linfit.restype = i32
            lib.nl_stack_clip_onchip.argtypes = [vp, vp, i32, i64, f32, f32, f32, i32,
                                                 i32, i32, i32, vp, vp, i32, vp]
            lib.nl_stack_clip_onchip.restype = i32
            lib.nl_stack_linfit_onchip.argtypes = [vp, i32, i64, f32, f32, f32, i32, i32,
                                                   i32, vp, vp, i32, vp]
            lib.nl_stack_linfit_onchip.restype = i32
            lib.nl_stack_single_pass.argtypes = [vp, i32, i64, i64, f32, f32, f32, i32,
                                                 vp, vp, vp, i32, vp]
            lib.nl_stack_single_pass.restype = i32
            lib.nl_stack_single_pass_onchip.argtypes = [vp, i32, i64, f32, f32, f32, i32, i32,
                                                        i32, i32, vp, vp, i32, vp]
            lib.nl_stack_single_pass_onchip.restype = i32
            lib.nl_sort_sum.argtypes = [vp, i64, i32, i32, i32, i32, i32, i32, i32, vp,
                                        i32, vp]
            lib.nl_sort_sum.restype = i32
            lib.nl_sort_sum_ring_blocks_per_sm.argtypes = [i32, i32, i32, i32, vp]
            lib.nl_sort_sum_ring_blocks_per_sm.restype = i32
            lib.nl_gather_patches.argtypes = [vp, i32, i32, vp, vp, i32, i32, vp, vp,
                                              i32, vp]
            lib.nl_gather_patches.restype = i32
            lib.nl_warp_shift.argtypes = [vp, i32, i32, i32, i32, *[f32] * 7, i32, i32, i32,
                                          i32, i32, i32, i32, vp, i32, vp]
            lib.nl_warp_shift.restype = i32
            lib.nl_detect_finish.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, vp, vp, f32, f32,
                                             f32, vp, vp, i32, i32, vp]
            lib.nl_detect_finish.restype = i32
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def launch_on(device: torch.device) -> tuple:
    """The (device ordinal, stream) pair that ends every launching C entry:
    the entry makes the ordinal its runtime's current device and launches
    on PyTorch's current stream of that card."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (on any
    card: the entry points take the device)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
