"""JPEG export (reference: internal/fits/writejpg.go), mirror of
nightlight_tpu/io/jpeg.py: v' = clip((v-min)/(max-min), 0, 1), NaN -> 0,
optional gamma, quantized to uint8 on the image's device, quality 95.
Pillow is imported by the writers only."""

from __future__ import annotations

import numpy as np

from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.ops.pixelmath import quantize_for_export


def _scaled_u8(img: Image, vmin: float, vmax: float, gamma: float) -> np.ndarray:
    return quantize_for_export(img.data, vmin, vmax, float(gamma), 255.0).cpu().numpy()


def write_jpg(img: Image, file_name: str, vmin: float, vmax: float, gamma: float = 1.0,
              quality: int = 95) -> None:
    """Write a colour 8-bit JPEG (writejpg.go:29-89)."""
    from PIL import Image as PILImage

    u8 = _scaled_u8(img, vmin, vmax, gamma)  # (3, H, W)
    PILImage.fromarray(np.ascontiguousarray(np.transpose(u8, (1, 2, 0))), mode="RGB").save(
        file_name, format="JPEG", quality=quality)


def write_mono_jpg(img: Image, file_name: str, vmin: float, vmax: float, gamma: float = 1.0,
                   quality: int = 95) -> None:
    """Write a mono 8-bit JPEG (writejpg.go:92-133)."""
    from PIL import Image as PILImage

    u8 = _scaled_u8(img, vmin, vmax, gamma)
    PILImage.fromarray(u8, mode="L").save(file_name, format="JPEG", quality=quality)
