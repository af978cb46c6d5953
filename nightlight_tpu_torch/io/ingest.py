"""Read-ahead FITS ingest of the port: frames are read from disk on worker
threads ahead of their use, so that reading overlaps the card's work on
earlier frames. Mirror of nightlight_tpu/io/ingest.py (BulkUploader,
prefetch_frames) and of the decode-ahead _DecodePrefetcher of
nightlight_tpu/pipeline/operators.py (reference: the goroutine promise
pool, internal/ops/operator.go:73-116).

On a CUDA device a worker reads a BITPIX 8/16 payload with `readinto`
straight into a pinned host buffer from a small recycled pool, copies it
to the card with `non_blocking=True` on a side stream and waits for the
side stream before it hands the frame over (and the buffer back); the
raw integers wait on the card, undecoded, at raw size (half the float32
bytes for BITPIX 16). The consumer's `get` decodes them on its current
stream (io/fits.attach_raw) and returns the Image. Float, wider-integer and TIFF payloads are decoded on the host by
the worker and copied to the device by the consumer, as the JAX package
does. On the CPU device the same threads read in the same order, into
plain host memory, with no stream.

Left out, with the TPU transport they served (ROADMAP.md, North star):
groups of frames in one transfer, the bit-packed wire format
(io/pack.py), the EMA of the wire rate that gated it, and the `Ingest:`
summary line.
"""

from __future__ import annotations

import collections
import contextlib
import io
import math
import threading
import time

import torch

# raw payload bytes read ahead of consumption: BulkUploader's window of
# WINDOW groups of GROUP_BYTES, twice (nightlight_tpu/io/ingest.py:373)
WINDOW_BYTES = 6 * (32 << 20) * 2
# reader threads and, without a byte window, frames ahead of consumption:
# _DecodePrefetcher's depth and lookahead (nightlight_tpu/pipeline/
# operators.py:279)
DEPTH = 3
LOOKAHEAD = 6


class _Frame:
    """One frame's read, filled by the thread that reads it (a worker, or
    the consumer inline) and taken by the consumer."""

    __slots__ = ("admitted", "budget", "started", "done", "img", "raw", "log", "error")

    def __init__(self, admitted: bool, budget: int = 0):
        self.admitted = admitted  # counted in the window (else claimed inline)
        self.budget = budget  # bytes it holds of the window
        self.started = False
        self.done = threading.Event()
        self.img = self.raw = self.error = None
        self.log = ""


class _PinnedPool:
    """Pinned host buffers, at most `size` of them, handed out for one read
    and its copy each. A buffer comes back only after its copy to the card
    has completed (the reader synchronises the side stream first), so a
    refill can never race an async copy out of it."""

    def __init__(self, size: int):
        self._size = size
        self._free: list[torch.Tensor] = []
        self._count = 0
        self._cond = threading.Condition()
        self.pinned = 0  # buffers pinned over the pool's life
        self.pin_seconds = 0.0  # spent pinning them

    def acquire(self, nbytes: int) -> torch.Tensor:
        with self._cond:
            while True:
                for i, buf in enumerate(self._free):
                    if buf.numel() >= nbytes:
                        return self._free.pop(i)
                if self._count < self._size:
                    self._count += 1
                    break
                if self._free:  # every free buffer is too small: replace one
                    self._free.pop(0)
                    break
                self._cond.wait()
        t0 = time.perf_counter()
        try:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        except BaseException:
            with self._cond:
                self._count -= 1
                self._cond.notify()
            raise
        with self._cond:
            self.pinned += 1
            self.pin_seconds += time.perf_counter() - t0
        return buf

    def release(self, buf: torch.Tensor) -> None:
        with self._cond:
            self._free.append(buf)
            self._cond.notify()

    def clear(self) -> None:
        """Drop the free buffers (to the caching host allocator)."""
        with self._cond:
            self._count -= len(self._free)
            self._free.clear()


class ReadAheadLoader:
    """Frames of a load set read ahead of their consumption.

    Readers take frames in the consumption order announced by `reorder`
    (OpStackBatches announces each out-of-core batch), then in spec order.
    They start at the consumer's first call (`get`, `reorder` or
    `prefetch_ahead`), as BulkUploader uploads nothing before its first
    `get`: a batch plan measured before the first load sees no frame of
    the loader on the device. Admission runs on the consumer's side (each
    of those calls), so which frames are in flight at any moment follows
    from the consumer's calls alone: with a byte window, until the admitted raw
    payload not yet consumed reaches `window_bytes` (BulkUploader._advance);
    without one, `lookahead` frames (_DecodePrefetcher's slots).
    `prefetch_ahead` admits a future batch's frames beyond the window.

    A frame that no reader has started when the consumer asks for it is
    read inline by the consumer (_DecodePrefetcher's claim protocol), so
    consuming in any order never waits on frames behind a full window. A
    reader's exception is raised by `get` for that frame. What a read
    writes to the log (header warnings) is written by the consumer when it
    takes the frame; no reader writes to the log. `get` may be called from
    several threads. `close` stops the readers and drops the buffers.
    """

    def __init__(self, specs: list[tuple[int, str]], log, device, frame_bytes: int = 0,
                 window_bytes: int | None = WINDOW_BYTES, lookahead: int | None = None,
                 depth: int = DEPTH):
        self.device = torch.device(device)
        self._log = log
        self._ids = {name: id_ for id_, name in specs}
        self._spec_order = [name for _, name in specs]
        self._unread = set(self._spec_order)  # neither admitted nor claimed
        self._taken: set[str] = set()  # handed to a consumer (or being)
        self._frames: dict[str, _Frame] = {}  # admitted or claimed, not taken
        self._queue: collections.deque[str] = collections.deque()  # admitted, in order
        self._order = list(self._spec_order)
        self._cursor = 0
        self._spec_cursor = 0
        self._frame_bytes = frame_bytes  # the admission estimate until a frame is read
        self._window_bytes = window_bytes
        self._lookahead = lookahead
        self._ahead_bytes = 0
        self._ahead_frames = 0
        self._running = False
        self._closed = False
        self._cond = threading.Condition()
        self.read_seconds = 0.0  # summed over the workers' reads
        self.inline_reads = 0  # frames the consumer had to read itself
        self.wait_seconds = 0.0  # the consumer's waits for a worker's read
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
            self._pool = _PinnedPool(depth + 1)
        self._threads = [threading.Thread(target=self._work, daemon=True,
                                          name=f"read-ahead-{i}") for i in range(depth)]

    @classmethod
    def try_create(cls, specs: list[tuple[int, str]], log, device):
        """A loader with the byte window when the first file's header says
        the raw-upload path applies (BITPIX 8/16, at least 4 frames, not
        TIFF), else None: BulkUploader.try_create's gates."""
        from nightlight_tpu_torch.io.fits import _BITPIX_DTYPES, read_file

        if len(specs) < 4:
            return None
        name = specs[0][1]
        if name.lower().endswith((".tif", ".tiff")):
            return None
        try:
            hdr = read_file(name, id=specs[0][0], log=log, read_data=False)
        except (OSError, EOFError, ValueError):  # the frame's own load reports it
            return None
        if hdr.bitpix not in (8, 16):
            return None
        frame_bytes = math.prod(hdr.naxisn) * _BITPIX_DTYPES[hdr.bitpix].itemsize
        return cls(specs, log, device, frame_bytes=frame_bytes)

    @property
    def pinned_buffers(self) -> int:
        """Pinned buffers allocated so far (0 off a CUDA device)."""
        return self._pool.pinned if self._pool is not None else 0

    @property
    def pin_seconds(self) -> float:
        """Seconds the readers spent pinning those buffers."""
        return self._pool.pin_seconds if self._pool is not None else 0.0

    def reorder(self, names: list[str]) -> None:
        """Announce the upcoming consumption order (one out-of-core batch):
        readers take these frames next, then the rest in spec order."""
        with self._cond:
            self._order = [n for n in names if n in self._unread]
            self._cursor = 0
            self._start()
            self._admit()

    def prefetch_ahead(self, names: list[str], max_bytes: int) -> int:
        """Admit the frames of `names` (a future batch's load order) that
        are not already in flight, beyond the window, until their raw
        payload passes `max_bytes`; the number admitted. Without a byte
        window (the decode-ahead gate, which the JAX package gives no
        prefetch) it admits nothing."""
        if self._window_bytes is None:
            return 0
        admitted = 0
        with self._cond:
            self._start()
            for name in names:
                if self._closed:
                    break
                if admitted * self._frame_bytes >= max_bytes:
                    break
                if name in self._unread:
                    self._admit_frame(name)
                    admitted += 1
        return admitted

    def get(self, name: str):
        """The decoded Image of `name` on the loader's device. A name not in
        the specs, or taken before, is read directly (io/fits.read_file)."""
        from nightlight_tpu_torch.io.fits import read_file

        with self._cond:
            self._start()
            fr = self._frames.get(name)
            managed = not self._closed and name not in self._taken and (
                fr is not None or name in self._unread)
            inline = False
            if managed:
                self._taken.add(name)
                if fr is None:  # never admitted: read here, outside the window
                    self._unread.discard(name)
                    fr = self._frames[name] = _Frame(admitted=False)
                    self._cond.notify_all()  # readers stop once nothing is unread
                if not fr.started:  # claim it from the readers
                    fr.started = inline = True
                    self.inline_reads += 1
        if not managed:
            return read_file(name, id=self._ids.get(name, 0), log=self._log,
                             device=self.device)
        if inline:
            self._read(name, fr, inline=True)
        t0 = time.perf_counter()
        fr.done.wait()
        with self._cond:
            if not inline:
                self.wait_seconds += time.perf_counter() - t0
            del self._frames[name]
            if fr.admitted:
                self._ahead_bytes -= fr.budget
                self._ahead_frames -= 1
            self._admit()
        if fr.log:
            self._log.write(fr.log)
        if fr.error is not None:
            raise fr.error
        return self._finish(fr)

    def close(self) -> None:
        """Stop the readers (a read in progress completes), drop the frames
        not taken and the pinned buffers."""
        with self._cond:
            self._closed = True
            self._queue.clear()
            self._cond.notify_all()
        for t in self._threads if self._running else ():
            t.join()
        with self._cond:
            self._frames.clear()
        if self._pool is not None:
            self._pool.clear()

    # -- internals ---------------------------------------------------------

    def _start(self) -> None:
        """Start the readers and the first admissions, once (lock held)."""
        if not self._running and not self._closed:
            self._running = True
            for t in self._threads:
                t.start()
            self._admit()

    def _admit(self) -> None:
        """Admit frames in order while the window has room (lock held)."""
        while not self._closed:
            if self._window_bytes is not None and self._ahead_bytes >= self._window_bytes:
                return
            if self._lookahead is not None and self._ahead_frames >= self._lookahead:
                return
            name = self._next_unread()
            if name is None:
                return
            self._admit_frame(name)

    def _admit_frame(self, name: str) -> None:
        self._unread.discard(name)
        self._frames[name] = _Frame(admitted=True, budget=self._frame_bytes)
        self._queue.append(name)
        self._ahead_bytes += self._frame_bytes
        self._ahead_frames += 1
        self._cond.notify_all()

    def _next_unread(self) -> str | None:
        """The next unread frame of the announced order, then of spec
        order (BulkUploader._upload_next_group's fallback)."""
        while self._cursor < len(self._order):
            if self._order[self._cursor] in self._unread:
                return self._order[self._cursor]
            self._cursor += 1
        while self._spec_cursor < len(self._spec_order):
            if self._spec_order[self._spec_cursor] in self._unread:
                return self._spec_order[self._spec_cursor]
            self._spec_cursor += 1
        return None

    def _work(self) -> None:
        on_card = torch.cuda.device(self.device) if self._stream is not None \
            else contextlib.nullcontext()
        with on_card:
            while True:
                with self._cond:
                    while not self._closed and not self._queue and self._unread:
                        self._cond.wait()
                    if self._closed or not self._queue:
                        return  # closed, or every frame admitted and started
                    name = self._queue.popleft()
                    fr = self._frames.get(name)
                    if fr is None or fr.started:  # claimed inline (and maybe taken)
                        continue
                    fr.started = True
                self._read(name, fr)

    def _read(self, name: str, fr: _Frame, inline: bool = False) -> None:
        """Read one frame (on a worker, or inline on the consumer); any
        error is handed to the consumer's get."""
        from nightlight_tpu_torch.io.fits import read_raw

        t0 = time.perf_counter()
        held = []
        log = io.StringIO()

        def pinned(nbytes):
            held.append(self._pool.acquire(nbytes))
            return held[-1][:nbytes]

        try:
            if self._stream is None:
                fr.img, fr.raw = read_raw(name, id=self._ids[name], log=log)
            else:
                fr.img, raw = read_raw(name, id=self._ids[name], log=log, alloc=pinned)
                if raw is not None:
                    with torch.cuda.stream(self._stream):
                        fr.raw = torch.empty(raw.numel(), dtype=torch.uint8, device=self.device)
                        fr.raw.copy_(raw, non_blocking=True)
                    # the copy has landed: the pinned buffer is free again,
                    # and the consumer's stream needs no wait on it
                    self._stream.synchronize()
        except BaseException as e:  # noqa: BLE001 - raised by get for this frame
            fr.error = e
        finally:
            for buf in held:
                self._pool.release(buf)
            fr.log = log.getvalue()
            with self._cond:
                if not inline:
                    self.read_seconds += time.perf_counter() - t0
                if fr.admitted and fr.error is None:  # the window counts what was read
                    held_bytes = (fr.raw.numel() if fr.raw is not None
                                  else fr.img.data.numel() * fr.img.data.element_size())
                    self._ahead_bytes += held_bytes - fr.budget
                    fr.budget = held_bytes
            fr.done.set()

    def _finish(self, fr: _Frame):
        """Decode a raw payload on the consumer's stream, or move a host-
        decoded image to the device."""
        from nightlight_tpu_torch.io.fits import attach_raw

        img = fr.img
        if fr.raw is not None:
            if self._stream is not None:  # allocated on the side stream
                fr.raw.record_stream(torch.cuda.current_stream(self.device))
            return attach_raw(img, fr.raw)
        img.data = img.data.to(self.device)
        img.stats.replace_data(img.data)
        return img


def prefetch_frames(file_names, depth: int = 4, device="cpu", log=None):
    """Yield the decoded Images of `file_names` in order, ids 0, 1, ...,
    reading up to `depth` frames ahead on `depth` threads
    (nightlight_tpu/io/ingest.py:prefetch_frames). A read's error is raised
    when its frame is due."""
    names = list(file_names)
    if not names:
        return
    loader = ReadAheadLoader(list(enumerate(names)), log or io.StringIO(), device,
                             window_bytes=None, lookahead=depth, depth=depth)
    try:
        for name in names:
            yield loader.get(name)
    finally:
        loader.close()
