"""The cells' inputs: synthetic star fields made on the card from a seed and
written as BITPIX-16 FITS lights and masters.

One configuration file (configs/<config>.json, key "generator") sets the
field: frame size, sky and its gradient, vignetting (applied to the lights
and recorded in the master flat), read and shot noise, a fixed bias pattern
with hot pixels (in the master dark and, with a per-frame drift, in the
lights), a power-law star field, the seeing of each light, dithers and
rotations about the frame's centre, a satellite trail in one light in ten,
and for one-shot-colour lights the CFA pattern and channel gains. The
traffic file sets the number of lights.

The small draws (star places, the order of the fluxes, seeings, dithers
and rotations, hot pixels, trails) come from numpy's PCG64 seeded with the
seed;
the pixel noise comes from a torch.Generator on the card seeded with it.
Stars are added with a deterministic scatter, so the same seed on the same
card gives the same bytes.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

FITS_BLOCK = 2880
STAR_RADIUS = 10  # half-width of the window each star is drawn into


@dataclass
class Inputs:
    """The files a job reads: the lights in load order and the masters."""

    lights: list = field(default_factory=list)
    dark: str | None = None
    flat: str | None = None
    bytes_written: int = 0


def rotation(theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s], [s, c]])


def fits16_bytes(q: torch.Tensor, exposure: float) -> bytes:
    """A BITPIX-16 FITS file (BZERO 32768) of the integer-valued (H, W)
    tensor q in [0, 65535]: the header of nightlight_tpu_torch/fixtures.py
    and the big-endian payload padded to whole blocks."""
    h, w = q.shape
    cards = [("SIMPLE", "T"), ("BITPIX", "16"), ("NAXIS", "2"), ("NAXIS1", str(w)),
             ("NAXIS2", str(h)), ("BZERO", "32768"), ("BSCALE", "1"),
             ("EXPOSURE", f"{float(exposure):.1f}")]
    header = "".join(f"{k:<8}= {v:>20} / {'':47}" for k, v in cards) + "END" + " " * 77
    header += " " * (-len(header) % FITS_BLOCK)
    signed = (q.to(torch.int32) - 32768).to(torch.int16).cpu().numpy()
    payload = signed.astype(">i2").tobytes()
    return header.encode("ascii") + payload + b"\0" * (-len(payload) % FITS_BLOCK)


def _quantize(x: torch.Tensor, max_adu: float) -> torch.Tensor:
    """floor(x + 0.5) within [0, max_adu], as a camera's ADC."""
    return torch.floor(x.clamp(0.0, float(max_adu)) + 0.5)


def _cfa_gain(p: dict, h: int, w: int, device) -> torch.Tensor | None:
    cfa = p.get("cfa")
    if not cfa:
        return None
    gains = p["channel_gains"]
    tile = torch.tensor([[gains[cfa[0]], gains[cfa[1]]], [gains[cfa[2]], gains[cfa[3]]]],
                        dtype=torch.float32, device=device)
    return tile.repeat(h // 2, w // 2)


def _star_values(pos: torch.Tensor, flux: torch.Tensor, sigma: float, h: int, w: int):
    """Flat indices and values of every star's window: a circular gaussian
    of total `flux` about its position, sampled at pixel centres."""
    off = torch.arange(-STAR_RADIUS, STAR_RADIUS + 1, device=pos.device, dtype=torch.float32)
    ix = torch.round(pos[:, 0])[:, None, None] + off[None, None, :]
    iy = torch.round(pos[:, 1])[:, None, None] + off[None, :, None]
    r2 = (ix - pos[:, 0, None, None]) ** 2 + (iy - pos[:, 1, None, None]) ** 2
    val = (flux / (2.0 * math.pi * sigma * sigma))[:, None, None] * torch.exp(
        -r2 / (2.0 * sigma * sigma))
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = (iy * w + ix).to(torch.int64)
    return flat[inside], val[inside]


def _spread(rng, lo: float, hi: float, n: int) -> np.ndarray:
    """n values evenly spaced over [lo, hi], in an order drawn from rng."""
    return rng.permutation(np.linspace(lo, hi, n)) if n > 1 else np.array([(lo + hi) / 2.0])


def draw(p: dict, n: int, seed: int) -> dict:
    """The host-side draws of a run: star sky positions and fluxes, hot
    pixels, and per light its seeing, dither, rotation and trail. A light
    sees the sky point R(theta)(x - centre) + centre + dither at its pixel
    x. Every seed gets the same set of fluxes (the power law's quantiles),
    hot-pixel values, seeings, dithers and rotations, placed and ordered
    by the seed, so that the work of a job does not depend on the seed.
    With "order": "fixed" the seeings, dithers and rotations come in one
    order for every seed; with "trails": "fixed" the trails are
    fixed_trails' (else a light in trail_every from a phase drawn from the
    seed, each through a point and at an angle drawn from it)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    h, w = p["height"], p["width"]
    stars = p["stars"]
    sky_xy = rng.uniform([0.0, 0.0], [w, h], size=(stars, 2))
    u = (np.arange(stars) + 0.5) / max(stars, 1)
    flux = np.minimum(p["flux_min_adu"] * u ** (-1.0 / p["flux_power"]), p["flux_max_adu"])
    hot_idx = rng.choice(h * w, size=p["hot_pixels"], replace=False)
    hot_adu = _spread(rng, *p["hot_adu"], p["hot_pixels"])
    fwhm = _spread(rng, *p["fwhm_px"], n)
    dither = np.stack([_spread(rng, -p["dither_px"], p["dither_px"], n) for _ in range(2)], 1)
    theta = np.deg2rad(_spread(rng, -p["rotation_deg"], p["rotation_deg"], n))
    hot_drift = rng.uniform(-p["hot_drift"], p["hot_drift"], size=(n, p["hot_pixels"]))
    phase = int(rng.integers(p["trail_every"]))
    trails = []
    for i in range(n):
        pt = rng.uniform([0.0, 0.0], [w, h])
        ang = rng.uniform(0.0, math.pi)
        trails.append((float(pt[0]), float(pt[1]), float(ang))
                      if i % p["trail_every"] == phase else None)
    if p.get("order") == "fixed":
        # the same seeing, dither and rotation in light i for every seed
        fixed = np.random.Generator(np.random.PCG64(0))
        fwhm = _spread(fixed, *p["fwhm_px"], n)
        dither = np.stack([_spread(fixed, -p["dither_px"], p["dither_px"], n)
                           for _ in range(2)], 1)
        theta = np.deg2rad(_spread(fixed, -p["rotation_deg"], p["rotation_deg"], n))
    if p.get("trails") == "fixed":
        trails = fixed_trails(p, n)
    return {"sky_xy": sky_xy, "flux": flux, "hot_idx": hot_idx, "hot_adu": hot_adu,
            "fwhm": fwhm, "dither": dither, "theta": theta,
            "hot_drift": hot_drift, "trails": trails}


def fixed_trails(p: dict, n: int) -> list:
    """n // trail_every trails, in lights trail_every // 2, trail_every //
    2 + trail_every, ..., each through the frame's centre at angles spread
    evenly over [0, pi): the same trails, of the same lengths, in the same
    lights for every seed."""
    every = p["trail_every"]
    k = n // every
    centre = ((p["width"] - 1) / 2.0, (p["height"] - 1) / 2.0)
    trails = [None] * n
    for j in range(k):
        trails[j * every + every // 2] = (centre[0], centre[1], (j + 0.5) * math.pi / k)
    return trails


def generate(p: dict, n: int, seed: int, outdir: str, device) -> Inputs:
    """Write n lights (light000.fits ...), dark.fits and, with "flat",
    flat.fits into outdir."""
    device = torch.device(device)
    h, w = p["height"], p["width"]
    d = draw(p, n, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    centre = ((w - 1) / 2.0, (h - 1) / 2.0)
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    rr = ((xs - centre[0]) ** 2 + (ys - centre[1]) ** 2) / (centre[0] ** 2 + centre[1] ** 2)
    vignette = 1.0 - p["vignetting"] * rr
    gx, gy = p["sky_gradient_adu"]
    sky = p["sky_adu"] + gx * xs / w + gy * ys / h
    cfa_gain = _cfa_gain(p, h, w, device)
    hot_idx = torch.as_tensor(d["hot_idx"], device=device)
    hot_adu = torch.as_tensor(d["hot_adu"], dtype=torch.float32, device=device)
    bias = p["bias_adu"] + p["bias_sigma_adu"] * torch.randn((h, w), generator=gen,
                                                              device=device)
    max_adu = p["max_adu"]
    exposure = p["exposure_s"]
    sky_xy = torch.as_tensor(d["sky_xy"], dtype=torch.float64, device=device)
    flux = torch.as_tensor(d["flux"], dtype=torch.float32, device=device)
    os.makedirs(outdir, exist_ok=True)
    inputs = Inputs()
    futures = []
    pool = ThreadPoolExecutor(max_workers=2)

    def write(name: str, q: torch.Tensor) -> str:
        data = fits16_bytes(q, exposure)
        path = os.path.join(outdir, name)

        def save():
            # on the disk before the first job, so that no writeback of the
            # inputs runs during the window
            with open(path, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            return len(data)

        futures.append(pool.submit(save))
        return path

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        dark = bias.clone().reshape(-1)
        dark[hot_idx] += hot_adu
        inputs.dark = write("dark.fits", _quantize(dark.reshape(h, w), max_adu))
        del dark
        if p["flat"]:
            flat = vignette * p["flat_adu"] + p["flat_noise_adu"] * torch.randn(
                (h, w), generator=gen, device=device)
            inputs.flat = write("flat.fits", _quantize(flat, max_adu))
            del flat
        for i in range(n):
            th = float(d["theta"][i])
            rot = torch.as_tensor(rotation(-th), dtype=torch.float64, device=device)
            c = torch.as_tensor(centre, dtype=torch.float64, device=device)
            shift = torch.as_tensor(d["dither"][i], dtype=torch.float64, device=device)
            pos = ((sky_xy - c - shift) @ rot.T + c).to(torch.float32)
            sigma = float(d["fwhm"][i]) / (2.0 * math.sqrt(2.0 * math.log(2.0)))
            idx, val = _star_values(pos, flux, sigma, h, w)
            signal = sky.clone().reshape(-1)
            signal.index_put_((idx,), val, accumulate=True)
            signal = signal.reshape(h, w)
            trail = d["trails"][i]
            if trail is not None:
                tx, ty, ang = trail
                dist = (xs - tx) * math.sin(ang) - (ys - ty) * math.cos(ang)
                signal = signal + p["trail_adu"] * torch.exp(
                    -dist * dist / (2.0 * p["trail_sigma_px"] ** 2))
            signal = signal * vignette
            if cfa_gain is not None:
                signal = signal * cfa_gain
            noise = torch.sqrt(p["read_noise_adu"] ** 2 + signal / p["gain_e_per_adu"])
            light = bias + signal + noise * torch.randn((h, w), generator=gen, device=device)
            hot = hot_adu * (1.0 + torch.as_tensor(d["hot_drift"][i], dtype=torch.float32,
                                                   device=device))
            light = light.reshape(-1)
            light[hot_idx] += hot
            inputs.lights.append(write(f"light{i:03d}.fits",
                                      _quantize(light.reshape(h, w), max_adu)))
            del signal, light, noise
    finally:
        torch.use_deterministic_algorithms(deterministic)
        inputs.bytes_written = sum(f.result() for f in futures)
        pool.shutdown()
    return inputs
