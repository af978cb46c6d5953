"""JPEG export (reference: internal/fits/writejpg.go), mirror of
nightlight_tpu/io/jpeg.py: v' = clip((v-min)/(max-min), 0, 1), NaN -> 0,
optional gamma, quantized to uint8 on the image's device, quality 95.
Pillow is imported by the writers only. The file is encoded in memory and
then written, so that the save's spans tell encoding from writing."""

from __future__ import annotations

import io

import numpy as np

from nightlight_tpu_torch import trace
from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.ops.pixelmath import quantize_for_export


def _scaled_u8(img: Image, vmin: float, vmax: float, gamma: float) -> np.ndarray:
    with trace.span("save.fetch"):
        return trace.to_host(quantize_for_export(img.data, vmin, vmax, float(gamma),
                                                 255.0)).numpy()


def _save(pil_image, file_name: str, quality: int) -> None:
    with trace.span("save.encode"):
        buf = io.BytesIO()
        pil_image.save(buf, format="JPEG", quality=quality)
    with trace.span("save.write"), open(file_name, "wb") as f:
        f.write(buf.getbuffer())


@trace.span("save")
def write_jpg(img: Image, file_name: str, vmin: float, vmax: float, gamma: float = 1.0,
              quality: int = 95) -> None:
    """Write a colour 8-bit JPEG (writejpg.go:29-89)."""
    from PIL import Image as PILImage

    u8 = _scaled_u8(img, vmin, vmax, gamma)  # (3, H, W)
    _save(PILImage.fromarray(np.ascontiguousarray(np.transpose(u8, (1, 2, 0))), mode="RGB"),
          file_name, quality)


@trace.span("save")
def write_mono_jpg(img: Image, file_name: str, vmin: float, vmax: float, gamma: float = 1.0,
                   quality: int = 95) -> None:
    """Write a mono 8-bit JPEG (writejpg.go:92-133)."""
    from PIL import Image as PILImage

    u8 = _scaled_u8(img, vmin, vmax, gamma)
    _save(PILImage.fromarray(u8, mode="L"), file_name, quality)
