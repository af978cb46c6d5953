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

