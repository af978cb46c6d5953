"""TIFF16 export and TIFF import (reference: internal/fits/tiff16.go), mirror
of nightlight_tpu/io/tiff.py: v' = clip((v-min)/(max-min), 0, 1)**(1/gamma),
NaN -> 0, quantized to uint16 on the image's device. Pillow is imported by
the functions that use it."""

from __future__ import annotations

import struct

import numpy as np
import torch

from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.ops.pixelmath import quantize_for_export
from nightlight_tpu_torch.ops.stats import Stats


def _scaled_u16(img: Image, vmin: float, vmax: float, gamma: float) -> np.ndarray:
    q = quantize_for_export(img.data, vmin, vmax, float(gamma), 65535.0)
    return q.cpu().numpy().astype(np.uint16)


def write_tiff16(img: Image, file_name: str, vmin: float, vmax: float, gamma: float = 1.0) -> None:
    """Write a colour 16-bit uncompressed TIFF (tiff16.go:31-91)."""
    u16 = _scaled_u16(img, vmin, vmax, gamma)  # (3, H, W)
    _write_rgb48_tiff(file_name, np.ascontiguousarray(np.transpose(u16, (1, 2, 0))))


def write_mono_tiff16(img: Image, file_name: str, vmin: float, vmax: float, gamma: float = 1.0) -> None:
    """Write a mono 16-bit uncompressed TIFF (tiff16.go:94-130)."""
    from PIL import Image as PILImage

    u16 = _scaled_u16(img, vmin, vmax, gamma)
    h, w = u16.shape
    pil = PILImage.frombuffer("I;16", (w, h), np.ascontiguousarray(u16).astype("<u2").tobytes(),
                              "raw", "I;16", 0, 1)
    pil.save(file_name, format="TIFF", compression=None)


def _write_rgb48_tiff(file_name: str, data: np.ndarray) -> None:
    """Minimal RGB 16-bit-per-sample uncompressed little-endian TIFF, one
    strip (the reference writes it with golang.org/x/image/tiff)."""
    h, w, _ = data.shape
    payload = data.astype("<u2").tobytes()

    def entry(tag, typ, count, value):
        return struct.pack("<HHI4s", tag, typ, count, value)

    num_entries = 11
    header_size = 8
    ifd_size = 2 + num_entries * 12 + 4
    bits_offset = header_size + ifd_size
    data_offset = bits_offset + 6

    def val_short(v):
        return struct.pack("<HH", v, 0)

    def val_long(v):
        return struct.pack("<I", v)

    entries = [
        entry(256, 4, 1, val_long(w)),            # ImageWidth
        entry(257, 4, 1, val_long(h)),            # ImageLength
        entry(258, 3, 3, val_long(bits_offset)),  # BitsPerSample -> offset
        entry(259, 3, 1, val_short(1)),           # Compression = none
        entry(262, 3, 1, val_short(2)),           # Photometric = RGB
        entry(273, 4, 1, val_long(data_offset)),  # StripOffsets
        entry(277, 3, 1, val_short(3)),           # SamplesPerPixel
        entry(278, 4, 1, val_long(h)),            # RowsPerStrip
        entry(279, 4, 1, val_long(len(payload))),  # StripByteCounts
        entry(282, 3, 1, val_short(72)),          # XResolution
        entry(283, 3, 1, val_short(72)),          # YResolution
    ]
    with open(file_name, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", header_size))
        f.write(struct.pack("<H", num_entries))
        f.write(b"".join(entries))
        f.write(struct.pack("<I", 0))
        f.write(struct.pack("<HHH", 16, 16, 16))
        f.write(payload)


def read_tiff(file_name: str, id: int = 0, device="cpu") -> Image:
    """Read a TIFF image into a float32 Image on `device`."""
    from PIL import Image as PILImage

    arr = np.asarray(PILImage.open(file_name))
    data = arr.astype(np.float32)
    if data.ndim == 3:  # (H, W, C) -> (C, H, W)
        data = np.ascontiguousarray(np.transpose(data, (2, 0, 1))[:3])
        naxisn = [data.shape[2], data.shape[1], 3]
    else:
        naxisn = [data.shape[1], data.shape[0]]
    img = Image(id=id, file_name=file_name, naxisn=naxisn)
    img.data = torch.from_numpy(data).to(device)
    img.stats = Stats(img.data, naxisn[0])
    return img
