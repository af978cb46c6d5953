"""Synthetic FITS fixtures for the stack and colour paths, in numpy only.

The default recipe and seed of scripts/gen_fixtures.py (which imports the
JAX package): mono BITPIX-16 light frames with BZERO 32768, a master dark
they sit on, 40 gaussian stars of fwhm 8 px drifting (4, -3) px per frame,
and approximately gaussian sky noise (sum of three uniform u16 draws). The
same seed gives the same files as that script. With a CFA pattern (bayer=,
or --bayer on the command line) each light is a one-shot-colour mosaic:
the signal above the dark scales by the pixel's channel gain, R 1.0, G 0.8,
B 0.6; the master dark stays mono. With --channels it writes stacked-master
channel frames for `rgb`/`lrgb` instead (gen_channels, the recipe of
scripts/gen_fixtures.py gen_channels): one clean frame per channel of the
same star field at the channel's gain, chan_<name>.fits.

Beside the files, the inputs of a job on them: live_stacking_job, the JSON
job of tests/test_rest.py's live stacking, and plan_st_memory, the
-stMemory for which the port's batch planner makes a given number of
batches. Both import the port inside the call, so importing this module
needs numpy alone.

    python -m nightlight_tpu_torch.fixtures OUTDIR [N_FRAMES] [SIZE] [--bayer RGGB]
    python -m nightlight_tpu_torch.fixtures OUTDIR --channels [--size SIZE]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

CHANNEL_GAINS = {"R": 1.0, "G": 0.8, "B": 0.6}
LRGB_CHANNELS = (("l", 1.0), ("r", 1.0), ("g", 0.8), ("b", 0.6))
SHO_CHANNELS = (("s", 0.9), ("h", 1.0), ("o", 0.7))


def gen_channels(outdir: str, size: int = 4096, seed: int = 7,
                 channels: tuple = LRGB_CHANNELS) -> list[str]:
    """Write one stacked-master frame per (name, gain) of `channels` as
    BITPIX-16 chan_<name>.fits: 40 gaussian stars of fwhm 8 px at fixed
    places (the star field of gen), scaled by the gain, on a sky of 800
    times the gain with noise of 4 times the gain. Returns the file names."""
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
    names = []
    for name, gain in channels:
        acc = rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16).astype(np.float32)
        for _ in range(2):
            acc += rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
        img = (acc - 98302.5) * np.float32(4.0 * gain / 32768.0) + np.float32(800.0 * gain)
        for j in range(n_stars):
            icx, icy = int(round(sx[j])), int(round(sy[j]))
            blob = gain * flux[j] / (2 * np.pi * s * s) * np.exp(
                -(((xx + icx - sx[j]) ** 2) + ((yy + icy - sy[j]) ** 2)) / (2 * s * s))
            img[icy - patch_r:icy + patch_r + 1, icx - patch_r:icx + patch_r + 1] += blob
        np.clip(img, 0, 65535, out=img)
        img += 0.5
        raw = img.astype(np.uint16)
        signed = (raw ^ np.uint16(0x8000)).byteswap().view(">i2")
        fn = os.path.join(outdir, f"chan_{name}.fits")
        _write_fits16(fn, signed, w, h)
        names.append(fn)
    return names


def gen(outdir: str, n_frames: int = 24, size: int = 4096, seed: int = 7,
        bayer: str | None = None) -> list[str]:
    """Write `n_frames` lights (light000.fits ...) and dark.fits of size x
    size pixels into outdir, mosaicked in the CFA pattern `bayer` when one
    is given. Returns the light file names."""
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

    gain_map = None
    if bayer:
        cfa = bayer.upper()
        tile = np.array([[CHANNEL_GAINS[cfa[0]], CHANNEL_GAINS[cfa[1]]],
                         [CHANNEL_GAINS[cfa[2]], CHANNEL_GAINS[cfa[3]]]], np.float32)
        gain_map = np.tile(tile, (h // 2, w // 2))

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
        if gain_map is not None:
            img = dark + (img - dark) * gain_map
        # quantize to BITPIX 16, BZERO 32768: floor(x+0.5), sign bit flipped
        np.clip(img, 0, 65535, out=img)
        img += 0.5
        raw = img.astype(np.uint16)
        signed = (raw ^ np.uint16(0x8000)).byteswap().view(">i2")
        name = os.path.join(outdir, f"light{i:03d}.fits")
        _write_fits16(name, signed, w, h)
        names.append(name)
    return names


def plan_st_memory(n: int, size: int, device, batches: int, flags=None) -> int:
    """The smallest -stMemory, in steps of one frame's MiB, for which the
    port's own batch planner (OpStackBatches._partition) splits n size^2
    frames into `batches` batches of n // batches on this host: the planner
    of a JSON job's stackBatches (flags None) or of the CLI `stack` with
    `flags` (the fused executor's, with its reserve for the next batch).
    Raises ValueError when no budget does."""
    import io

    from nightlight_tpu_torch import cli
    from nightlight_tpu_torch.pipeline.context import new_context
    from nightlight_tpu_torch.pipeline.ops_stack import OpStackBatches

    if flags is None:
        planner = OpStackBatches()
    else:
        from nightlight_tpu_torch.models.presets import build_command_seq

        args = cli.build_parser().parse_args([*flags, "stack", "light*.fits"])
        cli.apply_command_defaults(args)
        planner = next(s for s in build_command_seq(args).steps
                       if isinstance(s, OpStackBatches))

    class Frame:
        naxisn = [size, size]
        file_name = "plan"

    frame_mib = max(1, size * size * 4 >> 20)
    for st in range(frame_mib, 4 * n * frame_mib + 1, frame_mib):
        c = new_context(log=io.StringIO(), st_memory=st, device=device)
        try:
            _, num_batches, batch_size, _ = planner._partition([Frame] * n, c)
        except ValueError:  # the budget fits no plan
            continue
        if (num_batches, batch_size) == (batches, n // batches):
            return st
    raise ValueError(f"no -stMemory plans {n} frames of {size}^2 as {batches} batches")


def live_stacking_job(out: str) -> dict:
    """tests/test_rest.py's live-stacking job (:182-195) on light*.fits,
    saving `out`."""
    return {"type": "seq", "steps": [
        {"type": "loadMany", "filePatterns": ["light*.fits"]},
        {"type": "stackBatches", "perBatch": {"type": "seq", "steps": [
            {"type": "starDetect", "radius": 16, "sigma": 15.0,
             "badPixelSigma": 5.0, "inOutRatio": 1.4},
            {"type": "selectRef", "target": 1, "mode": "%starsHFR"},
            {"type": "selectRef", "target": 0, "mode": "%starsHFR"},
            {"type": "matchHist", "mode": 2},
            {"type": "align", "k": 20, "threshold": 1.0, "oobMode": 0},
            {"type": "stack", "mode": 6, "sigmaLow": 2.75, "sigmaHigh": 2.75},
        ]}},
        {"type": "save", "filePattern": out},
    ]}


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Write synthetic BITPIX-16 lights and a dark.")
    ap.add_argument("outdir")
    ap.add_argument("n_frames", nargs="?", type=int, default=24)
    ap.add_argument("size_pos", metavar="SIZE", nargs="?", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--bayer", default=None, help="CFA pattern of one-shot-colour lights, e.g. RGGB")
    ap.add_argument("--channels", action="store_true",
                    help="write the L, R, G, B channel masters chan_<name>.fits instead")
    ap.add_argument("--size", type=int, default=None, help="frame edge (same as SIZE)")
    a = ap.parse_args(argv)
    size = a.size or a.size_pos
    if a.channels:
        names = gen_channels(a.outdir, size, a.seed)
        print(f"wrote {len(names)} channel masters to {a.outdir}")
        return
    names = gen(a.outdir, a.n_frames, size, a.seed, a.bayer)
    print(f"wrote {len(names)} lights + dark.fits to {a.outdir}")


if __name__ == "__main__":
    main()
