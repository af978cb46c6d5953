"""Per-job execution context (reference: internal/ops/operator.go:37-67),
mirror of nightlight_tpu/pipeline/context.py with an explicit torch device.

Log ordering. The JAX package buffers every log line that carries a lazily
resolved value (statistics, transforms) until the next flush point
(reference selection, a stats-report row, a save, the end of the run),
while a few writers (the goal-seek search, FITS warnings) write straight to
the log. The port computes eagerly, but keeps that buffer so its log comes
out in the same order: a line whose arguments expose ``render_deferred``
(or that arrives while the buffer holds lines) is rendered at once and held
until flush_log().
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from nightlight_tpu_torch.ops.stats import LSEstimatorMode


def total_memory_mb() -> int:
    try:
        return int(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 1024 / 1024)
    except (ValueError, OSError):
        return 8192


def default_device() -> torch.device:
    """cuda:0. Raises when no CUDA device is present: the port runs on the
    card, and the CPU (the kernels' plain versions) only when a caller asks
    for it by passing device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' to run on the CPU")
    return torch.device("cuda:0")


@dataclass
class Context:
    log: Any = sys.stdout
    ls_estimator_mode: LSEstimatorMode = LSEstimatorMode.SCMedianQn
    memory_mb: int = 0
    stack_memory_mb: int = 0
    max_threads: int = 0
    device: torch.device = field(default_factory=default_device)

    dark_frame: Any = None  # Image
    flat_frame: Any = None  # Image
    align_naxisn: Optional[list] = None
    align_stars: Any = None  # StarList
    align_hfr: float = 0.0
    match_histo: Any = None  # Stats
    lum_frame: Any = None  # Image: the luminance master of an LRGB combination
    ref_frame_error: Optional[Exception] = None

    stats_total: int = 0
    stats_processed: int = 0
    stats_file: Any = None

    lock: threading.Lock = field(default_factory=threading.Lock)
    _log_buffer: list = field(default_factory=list)
    _mesh: Any = None
    _owned: list = field(default_factory=list)  # read-ahead loaders of this run

    @property
    def mesh(self):
        """Optional parallel.mesh.Mesh (JAX: a jax.sharding.Mesh). When set,
        OpStack splits the batch cube by rows across it and runs the stack
        and the goal-seek per shard; frames stay whole on the mesh's lead
        device, which becomes the context's device."""
        return self._mesh

    @mesh.setter
    def mesh(self, mesh) -> None:
        self._mesh = mesh
        if mesh is not None:
            self.device = mesh.lead

    def __post_init__(self):
        if self.memory_mb == 0:
            self.memory_mb = total_memory_mb()
        if self.stack_memory_mb == 0:
            self.stack_memory_mb = self.memory_mb * 7 // 10
        if self.max_threads == 0:
            self.max_threads = os.cpu_count() or 4
        self.device = torch.device(self.device)

    def finalize(self) -> None:
        """Flush the log and close an unterminated stats report."""
        self.flush_log()
        if self.stats_file is not None:
            from nightlight_tpu_torch.pipeline.ops_ref import _SESSION_STATS_TRAILER

            self.logf("Writing statistics footer at end of run...\n")
            self.stats_file.write("]")
            self.stats_file.write(_SESSION_STATS_TRAILER)
            self.stats_file.close()
            self.stats_file = None

    def own(self, loader) -> None:
        """Tie a read-ahead loader (io/ingest.py) to this run: close()
        stops it."""
        self._owned.append(loader)

    def close(self) -> None:
        """Stop the run's loaders and free their buffers; a CLI run or a
        served job calls this when it ends, also when it fails."""
        owned, self._owned = self._owned, []
        for loader in owned:
            loader.close()

    def logf(self, fmt: str, *args) -> None:
        """Printf-style logging in the JAX package's order (module doc)."""
        processed = tuple(a.snapshot_for_log() if hasattr(a, "snapshot_for_log") else a
                          for a in args)
        lazy = any(hasattr(a, "render_deferred") for a in processed)
        rendered = tuple(a.render_deferred() if hasattr(a, "render_deferred") else a
                         for a in processed)
        msg = fmt % rendered if rendered else fmt
        if lazy or self._log_buffer:
            self._log_buffer.append(msg)
            return
        self._write(msg)

    def flush_log(self) -> None:
        buffered, self._log_buffer = self._log_buffer, []
        for msg in buffered:
            self._write(msg)

    def _write(self, msg: str) -> None:
        self.log.write(msg)
        if hasattr(self.log, "flush"):
            self.log.flush()


def new_context(log=None, st_memory: int = 0,
                ls_mode: LSEstimatorMode = LSEstimatorMode.SCMedianQn,
                device=None) -> Context:
    """ops.NewContext equivalent (operator.go:58-67) on `device` (default:
    cuda:0, which must be present)."""
    return Context(log=log or sys.stdout, ls_estimator_mode=ls_mode,
                   stack_memory_mb=st_memory,
                   device=device if device is not None else default_device())
