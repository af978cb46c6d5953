"""Where the load of one BITPIX-16 frame goes on an NVIDIA GPU, step by step.

    python -m nightlight_tpu_torch.scripts.load_split [--size 4096] [--frames 16] \
        [--out FILE] [--tag TEXT]

Writes `--frames` lights of nightlight_tpu_torch/fixtures.py (seed 7) and
loads each one in the steps of the direct path (io/fits.py before the
read-ahead loader), timed on the host clock with the card synchronised
after each step:

* "header parse": open the file and parse its 2880-byte header blocks;
* "read": the payload into a new `bytes` object (`f.read`);
* "copies": `np.frombuffer(...).copy()` and `torch.from_numpy`;
* "H2D pageable": `.to(device)` from that pageable copy;
* "decode": the byte swap and `v * bscale + bzero` on the card;
* "stats read-back": min, mean and max, read back as three floats.

Then the steps of the loader's path on the same files: "read (readinto
pinned)", the payload read straight into a pinned buffer; "H2D pinned",
a `non_blocking` copy on a side stream, waited for; "decode"; and
"stats read-back (one 3-vector)". Then the whole `fits.read_file` per
frame and, where the tree has `io/ingest.py`, the frames read through
its loader in order: the consumer's seconds a frame (its wait, the decode
and the stats) and the workers' read seconds a frame, which overlap the
consumer.

The files are written just before they are read, so a read hits the
page cache ("cache": "warm"). Before that, the four measurements run
once cold ("cache": "cold"): before each one the script drops the files
it wrote, and only those, from the page cache (phase_split.
evict_page_cache: fsync, then posix_fadvise DONTNEED). Prints one JSON
line for the cold round and one for the warm (milliseconds a frame: the
median over the frames), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import io
import json
import shutil
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from nightlight_tpu_torch import fixtures, trace
from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.io import fits
from nightlight_tpu_torch.ops.stats import min_mean_max
from nightlight_tpu_torch.scripts.phase_split import evict_page_cache, loader_seconds

BUILD = Path(__file__).resolve().parents[2] / "build"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _decode(v16: torch.Tensor, bscale: float, bzero: float, device) -> torch.Tensor:
    """The byte swap and scale of io/fits.py on an int16 view of the
    big-endian payload."""
    v = v16.to(torch.int32) & 0xFFFF
    swapped = ((v << 8) | (v >> 8)) & 0xFFFF
    ints = torch.where(swapped >= 0x8000, swapped - 0x10000, swapped)
    scale = torch.tensor(float(bscale), dtype=torch.float32, device=device)
    zero = torch.tensor(float(bzero), dtype=torch.float32, device=device)
    return ints.to(torch.float32) * scale + zero


class Steps:
    """Seconds of each named step, per frame, the card synchronised at
    each mark."""

    def __init__(self):
        self.seconds: dict[str, list] = {}
        self._t = 0.0

    def start(self) -> None:
        torch.cuda.synchronize()
        self._t = time.perf_counter()

    def mark(self, step: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds.setdefault(step, []).append(now - self._t)
        self._t = now

    def medians_ms(self) -> dict:
        return {k: statistics.median(v) * 1e3 for k, v in self.seconds.items()}


def _header(name: str):
    f = open(name, "rb")
    img = Image(file_name=name)
    fits.read(img, f, read_data=False, log=io.StringIO())
    if img.bitpix != 16:
        raise ValueError(f"{name}: BITPIX {img.bitpix}, not 16")
    return f, img, img.naxisn[0] * img.naxisn[1]


def direct_steps(names, device) -> dict:
    """The direct path's steps (io/fits.py before the loader)."""
    steps = Steps()
    for name in names:
        steps.start()
        f, img, pixels = _header(name)
        steps.mark("header parse")
        with f:
            raw = f.read(pixels * 2)
        steps.mark("read")
        host = torch.from_numpy(np.frombuffer(raw, dtype="<i2", count=pixels).copy())
        steps.mark("copies")
        dev = host.to(device)
        steps.mark("H2D pageable")
        data = _decode(dev, img.bscale, img.bzero, device)
        steps.mark("decode")
        mn, me, mx = min_mean_max(data.reshape(-1))
        _ = (float(mn), float(me), float(mx))
        steps.mark("stats read-back")
    return steps.medians_ms()


def pinned_steps(names, device) -> dict:
    """The loader's steps on the calling thread: readinto a pinned buffer,
    a non_blocking copy on a side stream, the decode, one read-back."""
    steps = Steps()
    side = torch.cuda.Stream(device=device)
    buf = None
    for name in names:
        steps.start()
        f, img, pixels = _header(name)
        steps.mark("header parse")
        nbytes = pixels * 2
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        with f:
            got = f.readinto(buf.numpy()[:nbytes])
        if got != nbytes:
            raise ValueError(f"{name}: short payload")
        steps.mark("read (readinto pinned)")
        with torch.cuda.stream(side):
            dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
            dev.copy_(buf[:nbytes], non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        torch.cuda.current_stream(device).wait_event(done)
        dev.record_stream(torch.cuda.current_stream(device))
        steps.mark("H2D pinned")
        data = _decode(dev.view(torch.int16), img.bscale, img.bzero, device)
        steps.mark("decode")
        mn, me, mx = min_mean_max(data.reshape(-1))
        _ = torch.stack((mn, me, mx)).tolist()
        steps.mark("stats read-back (one 3-vector)")
    return steps.medians_ms()


def read_file_ms(names, device) -> float:
    times = []
    for name in names:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = fits.read_file(name, log=io.StringIO(), device=device)
        img.stats._ensure_mmm()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def loader_ms(names, device):
    """The frames through io/ingest.py's loader, consumed in order: the
    consumer's milliseconds a frame (wait, decode, stats; the median, and
    its mean wait), the workers' read milliseconds a frame (overlapped)
    and their seconds pinning buffers, from the loader's spans (recorded
    here); None without it."""
    try:
        from nightlight_tpu_torch.io import ingest
    except ImportError:
        return None
    loader = ingest.ReadAheadLoader.try_create(list(enumerate(names)), io.StringIO(), device)
    times = []
    with trace.recording():
        first = len(trace.records())
        try:
            for name in names:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = loader.get(name)
                img.stats._ensure_mmm()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        finally:
            loader.close()
        spent = loader_seconds(trace.records()[first:])
    return {"consumer_ms": statistics.median(times) * 1e3, "consumer_total_s": sum(times),
            "workers_read_ms": spent["workers_read_s"] / len(names) * 1e3,
            "consumer_wait_ms": spent["wait_s"] / len(names) * 1e3,
            "pin_total_s": spent["pin_s"]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096, help="frame edge in pixels")
    ap.add_argument("--frames", type=int, default=16, help="lights to write and load")
    ap.add_argument("--out", help="append each JSON line to this file too")
    ap.add_argument("--tag", default="", help="mark of this run's lines")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("load_split: no CUDA device")
    device = torch.device("cuda:0")
    torch.zeros(1, device=device)
    card = card_line()
    print(card, flush=True)
    BUILD.mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="load-split-", dir=BUILD)
    rows = []
    try:
        names = fixtures.gen(work, opts.frames, opts.size, seed=7)
        for cache in ("cold", "warm"):
            row = {"tag": opts.tag, "card": card, "size": opts.size, "frames": opts.frames,
                   "cache": cache}
            for key, steps in (("direct_ms", direct_steps), ("pinned_ms", pinned_steps),
                               ("read_file_ms", read_file_ms), ("loader", loader_ms)):
                if cache == "cold":
                    evict_page_cache(names)
                row[key] = steps(names, device)
            print(json.dumps(row), flush=True)
            if opts.out:
                with open(opts.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            rows.append(row)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rows


if __name__ == "__main__":
    main()
