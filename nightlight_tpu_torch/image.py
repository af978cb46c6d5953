"""In-memory image model of the port.

Mirror of nightlight_tpu/image.py: an Image carries its FITS metadata and a
float32 torch tensor shaped (H, W) for mono images (or (3, H, W) for colour
cubes) on an explicit device; ``naxisn`` keeps the FITS axis order
(fastest-varying first: [width, height(, 3)]) for headers and log lines.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from nightlight_tpu_torch.ops.stats import Stats


@dataclass
class Header:
    """Parsed FITS header content (fits.go:119-129)."""

    bools: dict = field(default_factory=dict)
    ints: dict = field(default_factory=dict)
    floats: dict = field(default_factory=dict)
    strings: dict = field(default_factory=dict)
    dates: dict = field(default_factory=dict)
    comments: list = field(default_factory=list)
    history: list = field(default_factory=list)
    end: bool = False
    length: int = 0


FITS_BLOCK_SIZE = 2880
HEADER_LINE_SIZE = 80


@dataclass
class Image:
    """A FITS image with its pixels in a torch tensor. Light frames count up
    from 0; the dark is ID -1, the flat -2, an external reference -3."""

    id: int = 0
    file_name: str = ""
    header: Header = field(default_factory=Header)
    bitpix: int = -32
    bzero: float = 0.0
    bscale: float = 1.0
    naxisn: list = field(default_factory=list)
    data: Any = None  # torch.Tensor, (H, W) or (C, H, W) float32
    exposure: float = 0.0
    stats: Optional[Stats] = None
    median_diff_stats: Optional[Stats] = None
    stars: Any = None  # detect.stars.StarList
    hfr: float = 0.0
    trans: Any = None  # align.transform 6-vector
    residual: Any = 0.0
    align_threshold: Any = None  # pending alignment drop decision
    pending_warp_oob: Any = None  # deferred projection (ops_post.OpAlign)

    @classmethod
    def from_naxisn(cls, naxisn, data=None, ls_mode=None, device=None) -> "Image":
        """Image of the given FITS dimensions (fits.go:65-91); zeros on
        `device` when no data is given."""
        naxisn = [int(x) for x in naxisn]
        if data is None:
            data = torch.zeros(tuple(reversed(naxisn)), dtype=torch.float32,
                               device=device or "cpu")
        img = cls(naxisn=naxisn, data=data)
        img.stats = Stats(data, naxisn[0], ls_mode)
        return img

    @classmethod
    def from_numpy(cls, array: np.ndarray, device=None, ls_mode=None) -> "Image":
        """Image holding a copy of a (H, W) or (C, H, W) numpy array on
        `device` (the state handed between the JAX package and the port)."""
        arr = np.ascontiguousarray(array, dtype=np.float32)
        naxisn = list(reversed(arr.shape))
        return cls.from_naxisn(naxisn, torch.from_numpy(arr.copy()).to(device or "cpu"),
                               ls_mode=ls_mode)

    @classmethod
    def like(cls, other: "Image", data=None) -> "Image":
        """New image with the metadata of `other` (fits.go:95-115)."""
        if data is None:
            data = torch.zeros_like(other.data)
        img = cls(id=other.id, file_name=other.file_name, header=other.header,
                  bitpix=other.bitpix, bzero=other.bzero, bscale=other.bscale,
                  naxisn=list(other.naxisn), data=data, exposure=other.exposure,
                  stars=other.stars, hfr=other.hfr)
        img.stats = Stats(data, other.naxisn[0], other.stats.mode if other.stats else None)
        return img

    @property
    def width(self) -> int:
        return self.naxisn[0]

    @property
    def height(self) -> int:
        return self.naxisn[1]

    @property
    def pixels(self) -> int:
        return math.prod(self.naxisn) if self.naxisn else 0

    @property
    def device(self) -> torch.device:
        return self.data.device

    def dimensions_string(self) -> str:
        return "x".join(str(n) for n in self.naxisn)

    def set_data(self, data, naxisn=None) -> None:
        """Replace pixel data (and optionally dimensions), resetting stats."""
        self.data = data
        if naxisn is not None:
            self.naxisn = [int(x) for x in naxisn]
        mode = self.stats.mode if self.stats is not None else None
        self.stats = Stats(data, self.naxisn[0], mode)

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().to("cpu", torch.float32).numpy()
