"""Log plumbing of the CLI (mirror of nightlight_tpu/utils/logging.py).

The reference multi-writes its log to stdout plus an optional file with
%auto-derived naming (reference: cmd/nightlight/main.go:195-208, 448-456).
"""

from __future__ import annotations

import io
import os


def auto_fill(value: str, base: str, extension: str) -> str:
    """%auto filename derivation (main.go:448-456): replace the base file's
    extension; empty when there is no base."""
    if value == "%auto":
        if base:
            root, _ = os.path.splitext(base)
            return root + extension
        return ""
    return value


class MultiWriter(io.TextIOBase):
    """Tee writes to several file-like sinks (io.MultiWriter analog)."""

    def __init__(self, *sinks):
        self._sinks = [s for s in sinks if s is not None]

    def write(self, s: str) -> int:
        for sink in self._sinks:
            sink.write(s)
        return len(s)

    def flush(self) -> None:
        for sink in self._sinks:
            if hasattr(sink, "flush"):
                sink.flush()


class TimestampWriter(io.TextIOBase):
    """Prefix each log LINE with elapsed wall seconds ("[+12.34s] ").

    Opt-in phase attribution (NIGHTLIGHT_LOG_TIMES=1 in the CLI): ops log at
    host-side barriers, so the deltas between stamped lines show where the
    wall clock went — the per-phase split BASELINE.md records for the bench
    configs. Off by default; stamped logs would break the parity goldens."""

    def __init__(self, sink, clock=None):
        import time
        self._sink = sink
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self._at_line_start = True

    def write(self, s: str) -> int:
        out = []
        for ch in s:
            if self._at_line_start and ch != "\n":
                out.append(f"[+{self._clock() - self._t0:8.2f}s] ")
                self._at_line_start = False
            out.append(ch)
            if ch == "\n":
                self._at_line_start = True
        self._sink.write("".join(out))
        return len(s)

    def flush(self) -> None:
        if hasattr(self._sink, "flush"):
            self._sink.flush()
