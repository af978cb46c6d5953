"""In-memory image model of the port.

Mirror of nightlight_tpu/image.py: an Image carries its FITS metadata and a
float32 torch tensor shaped (H, W) for mono images (or (3, H, W) for colour
cubes) on an explicit device; ``naxisn`` keeps the FITS axis order
(fastest-varying first: [width, height(, 3)]) for headers and log lines.

Under ``Context.mesh`` ``data`` is a row-sharded value instead
(parallel/mesh.py RowSharded: one row block per mesh device, with the
tensor's ``shape``, ``dim()``, ``numel()`` and ``device``, the lead);
``to_numpy`` gathers it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from nightlight_tpu_torch import trace
from nightlight_tpu_torch.ops.stats import Stats
from nightlight_tpu_torch.parallel import mesh as pm


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
    data: Any = None  # torch.Tensor, (H, W) or (C, H, W) float32; or a RowSharded
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
            data = pm.per_block(torch.zeros_like, other.data)
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
        """The pixels on the host (a row-sharded image gathered)."""
        data = pm.gather(self.data, "to_numpy")
        with trace.host_read(data.device):
            return data.detach().to("cpu", torch.float32).numpy()


def bin_block_mean(d: torch.Tensor, n: int) -> torch.Tensor:
    """Mean of each n x n block over the last two axes, the trailing rows
    and columns that do not fill a block dropped. The block sums in the
    order XLA's CPU code sums a (1, 3)-axis mean of a power-of-two number
    of block columns, so there the port's bins equal the JAX package's: a
    2x2 block as its two row sums added, a larger one element by element in
    row order; then one multiplication by the float32 reciprocal of the
    count. Other widths XLA sums in row order, 1 ulp apart at most."""
    h, w = d.shape[-2], d.shape[-1]
    bh, bw = h // n, w // n
    blocks = d[..., :bh * n, :bw * n].reshape(*d.shape[:-2], bh, n, bw, n)
    if n == 2:
        acc = ((blocks[..., 0, :, 0] + blocks[..., 0, :, 1])
               + (blocks[..., 1, :, 0] + blocks[..., 1, :, 1]))
    else:
        acc = blocks[..., 0, :, 0]
        for i in range(n):
            for j in range(n):
                if i or j:
                    acc = acc + blocks[..., i, :, j]
    return acc * torch.tensor(1.0 / (n * n), dtype=torch.float32, device=d.device)


def bin_nxn(img: Image, n: int) -> Image:
    """NxN average-pooling downsample (fits.go:163-195); a row-sharded image
    shard by shard where each shard holds whole blocks, else gathered and
    placed back."""
    n = int(n)
    d = img.data
    if isinstance(d, pm.RowSharded):
        rows = d.shape[-2] // d.mesh.size
        if not d.replicated and rows % n == 0:
            # whole blocks in every shard: binned shard by shard
            shape = (*d.shape[:-2], d.shape[-2] // n, d.shape[-1] // n)
            binned = pm.map_blocks(lambda b: bin_block_mean(b, n), d, shape=shape)
        else:
            binned = pm.place_on_mesh(bin_block_mean(pm.gather(d, "bin"), n), d.mesh)
    else:
        binned = bin_block_mean(d, n)
    naxisn = [binned.shape[-1], binned.shape[-2]] + ([binned.shape[0]] if binned.dim() == 3
                                                      else [])
    out = Image.from_naxisn(naxisn, binned, ls_mode=img.stats.mode if img.stats else None)
    out.id, out.file_name, out.exposure = img.id, img.file_name, img.exposure
    return out


def image_from_stars(img: Image, hfr_multiple: float = 2.0) -> Image:
    """Render the detected stars of `img` as filled discs of radius
    hfr * hfr_multiple and value mass / (pi radius^2), later stars over
    earlier ones, on a copy of its pixels (fits.go:199-222). Host-side, as
    in the JAX package (nightlight_tpu/image.py image_from_stars): it only
    serves the -stars debug saves. A row-sharded image's pixels are
    gathered, and the rendering is one tensor on its lead device."""
    data = np.array(img.to_numpy())
    h, w = img.height, img.width
    stars = img.stars
    for k in range(len(stars) if stars is not None else 0):
        radius = float(stars.hfr[k]) * hfr_multiple
        color = float(stars.mass[k]) / (radius * radius * math.pi)
        r_int = int(math.ceil(radius))
        offs = np.arange(-r_int, r_int + 1)
        yy, xx = np.meshgrid(offs, offs, indexing="ij")
        mask = (yy * yy + xx * xx) <= radius * radius + 1e-6
        ys = int(stars.y[k]) + yy[mask]
        xs = int(stars.x[k]) + xx[mask]
        inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        data[..., ys[inside], xs[inside]] = color
    return Image.like(img, torch.from_numpy(data).to(img.device))
