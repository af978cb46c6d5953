"""Synthetic FITS fixtures for the stack path, in numpy only.

The default recipe and seed of scripts/gen_fixtures.py (which imports the
JAX package): mono BITPIX-16 light frames with BZERO 32768, a master dark
they sit on, 40 gaussian stars of fwhm 8 px drifting (4, -3) px per frame,
and approximately gaussian sky noise (sum of three uniform u16 draws). The
same seed gives the same files as that script.

    python -m nightlight_tpu_torch.fixtures OUTDIR [N_FRAMES] [SIZE]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def gen(outdir: str, n_frames: int = 24, size: int = 4096, seed: int = 7) -> list[str]:
    """Write `n_frames` mono lights (light000.fits ...) and dark.fits of
    size x size pixels into outdir. Returns the light file names."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    h = w = size
    n_stars = 40
    sx = rng.uniform(64, w - 64, n_stars).astype(np.float32)
    sy = rng.uniform(64, h - 64, n_stars).astype(np.float32)
    flux = rng.uniform(25000.0, 60000.0, n_stars).astype(np.float32)
    s = 8.0 / 2.3548
    patch_r = 24
    yy, xx = np.mgrid[-patch_r:patch_r + 1, -patch_r:patch_r + 1].astype(np.float32)

    dark = rng.normal(100.0, 3.0, size=(h, w)).astype(np.float32)
    dark_raw = (np.clip(np.round(dark), 0, 65535).astype(np.int32) - 32768).astype(">i2")
    _write_fits16(os.path.join(outdir, "dark.fits"), dark_raw, w, h)

    def _noise(loc: float, sigma: float) -> np.ndarray:
        # Irwin-Hall n=3: sum of three U(0, 65535) draws, rescaled
        acc = rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16).astype(np.float32)
        for _ in range(2):
            acc += rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
        return (acc - 98302.5) * np.float32(sigma / 32768.0) + np.float32(loc)

    names = []
    for i in range(n_frames):
        img = dark + _noise(900.0, 20.0)
        dx, dy = 4.0 * i, -3.0 * i
        for j in range(n_stars):
            cx, cy = sx[j] + dx, sy[j] + dy
            icx, icy = int(round(cx)), int(round(cy))
            if not (patch_r <= icx < w - patch_r and patch_r <= icy < h - patch_r):
                continue
            blob = flux[j] / (2 * np.pi * s * s) * np.exp(
                -(((xx + icx - cx) ** 2) + ((yy + icy - cy) ** 2)) / (2 * s * s))
            img[icy - patch_r:icy + patch_r + 1, icx - patch_r:icx + patch_r + 1] += blob
        # quantize to BITPIX 16, BZERO 32768: floor(x+0.5), sign bit flipped
        np.clip(img, 0, 65535, out=img)
        img += 0.5
        raw = img.astype(np.uint16)
        signed = (raw ^ np.uint16(0x8000)).byteswap().view(">i2")
        name = os.path.join(outdir, f"light{i:03d}.fits")
        _write_fits16(name, signed, w, h)
        names.append(name)
    return names


def _write_fits16(name: str, signed: np.ndarray, w: int, h: int) -> None:
    lines = [
        f"{'SIMPLE':<8}= {'T':>20} / {'':47}",
        f"{'BITPIX':<8}= {'16':>20} / {'':47}",
        f"{'NAXIS':<8}= {'2':>20} / {'':47}",
        f"{'NAXIS1':<8}= {w:>20} / {'':47}",
        f"{'NAXIS2':<8}= {h:>20} / {'':47}",
        f"{'BZERO':<8}= {'32768':>20} / {'':47}",
        f"{'BSCALE':<8}= {'1':>20} / {'':47}",
        f"{'EXPOSURE':<8}= {'120.':>20} / {'':47}",
        "END" + " " * 77,
    ]
    header = "".join(lines)
    header += " " * (2880 - len(header) % 2880)
    payload = signed.tobytes()
    pad = len(payload) % 2880
    with open(name, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)
        if pad:
            f.write(b"\0" * (2880 - pad))


if __name__ == "__main__":
    out = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    sz = int(sys.argv[3]) if len(sys.argv) > 3 else 4096
    print(f"wrote {len(gen(out, n, sz))} lights + dark.fits to {out}")
