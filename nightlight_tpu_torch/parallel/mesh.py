"""Device mesh and row-sharded values, mirror of
nightlight_tpu/parallel/mesh.py.

The JAX package drives every local device from one process: a 1-D
``jax.sharding.Mesh`` over the pixel rows, ``jit`` with shardings and
``shard_map``. The port does the same from one process with an ordered list
of torch devices (``Mesh``), and writes each collective out as a copy:

* a row-sharded value (``RowSharded``) holds one (..., H/n, W) block per
  mesh device, in mesh order, or, where the rows do not divide the mesh
  (JAX's ``P()``), one replicated copy on the lead device;
* ``psum`` of counts is a sum of the per-shard int64 counts on the lead
  device (``mesh.devices[0]``); the float reductions (``min_max``,
  ``sum64``) combine per-shard partials there, sums in float64;
* ``halo`` copies neighbour rows (``Tensor.to(dev, non_blocking=True)``),
  from as many shards as the halo spans, and tells the caller where the
  frame ends instead of sending zeros;
* ``take_flat`` gathers single pixels at global flat indices from the
  shards that own them; ``merge_top_k`` merges per-shard top-k lists on
  the lead;
* an all-gather is ``torch.cat`` of the blocks on the lead device
  (``RowSharded.gather``), counted per asking site in ``GATHERS``.

This is the one sharded path: the CLI's ``-shard`` sets ``Context.mesh``,
and every run with it set takes this path. Every loaded frame is
row-sharded at load (``place_on_mesh``; io/fits.py and io/ingest.py upload
each shard's rows straight to its device), and the per-frame operators of
the ``stack`` path run on each shard's rows: calibrate, bad-pixel repair,
statistics, star detection (``sharded_star_detect``), histogram match and
the warp (ops/resample.py). ``OpStack`` stacks each device's blocks into
its block of the batch cube (ops/stack.py ``stack_sharded``: each shard's
kernel on its device, the clip counts summed), and the stacked image stays
row-sharded through the final detection and the per-pixel stretch
operators; the writers gather.

A device may appear more than once in a mesh: the CPU tests run 8 shards on
the CPU (``make_mesh([torch.device("cpu")] * 8)``, beside JAX's 8 virtual
CPU devices), and ``chip_smoke.py`` runs 4 shards on one card. Each shard's
stack launches its kernel (K1, K2 or K3) on its own device. Every per-pixel
result is the same wherever it runs, so a sharded job equals the unsharded
one bit for bit.
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass

import numpy as np
import torch

from nightlight_tpu_torch import trace


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the pixel-row axis: the devices of its shards in
    order (one may repeat) and the axis name."""

    devices: tuple
    axis: str = "pix"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device that holds gathered and replicated values and the
        summed clip counts."""
        return self.devices[0]


# all-gathers of row-sharded values (replicated values cost none), by the
# site that asked for one: chip_smoke.py and the tests read which per-frame
# work took a frame whole
GATHERS: collections.Counter = collections.Counter()
trace.source("mesh.gathers", lambda: GATHERS)

# the batch planner's reserve of halo rows from each neighbour on every
# frame's shard (pipeline/ops_stack.py); the halo cap of the JAX package's
# warp dispatcher
HALO_CAP = 128


def _moved(site: str, t: torch.Tensor) -> None:
    """Count t's bytes, copied from one shard to another, in the tracer's
    mesh.bytes under `site`: from its shape, with no wait and no read.
    Counted: a gather's blocks of every shard but the lead's (under the
    gather's site), the rows a halo brings from the neighbours ("halo")
    and the blocks a split sends from the lead to the other shards
    ("rows"); an upload from host memory is no copy between shards."""
    trace.count("mesh.bytes", site, t.numel() * t.element_size())


class RowSharded:
    """A (..., H, W) value over a mesh: ``blocks`` holds the (..., H/n, W)
    row block of each mesh device in mesh order, or one copy on the lead
    device when ``replicated``. ``shape`` is the global shape."""

    def __init__(self, mesh: Mesh, shape, blocks: list, replicated: bool = False):
        self.mesh = mesh
        self.shape = torch.Size(shape)
        self.blocks = list(blocks)
        self.replicated = replicated

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def device(self) -> torch.device:
        """The lead device, where gathered values and reductions land."""
        return self.mesh.lead

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def spec(self) -> tuple:
        """The JAX PartitionSpec this placement stands for, as a tuple."""
        if self.replicated:
            return ()
        return (None,) * (self.dim() - 2) + (self.mesh.axis, None)

    @property
    def row0s(self) -> list[int]:
        """The first global row of each block."""
        if self.replicated:
            return [0]
        rows = self.shape[-2] // self.mesh.size
        return [k * rows for k in range(self.mesh.size)]

    def gather(self, site: str = "other") -> torch.Tensor:
        """The whole value on the lead device (an all-gather), counted in
        GATHERS under `site`."""
        if self.replicated:
            return self.blocks[0]
        GATHERS[site] += 1
        for b in self.blocks[1:]:
            _moved(site, b)
        lead = self.mesh.lead
        return torch.cat([_to(b, lead) for b in self.blocks], dim=-2)


def gather(x, site: str = "other") -> torch.Tensor:
    """x as one tensor: a RowSharded gathered on its lead device, a tensor
    as it is."""
    return x.gather(site) if isinstance(x, RowSharded) else x


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    # asynchronous between cards; a copy to the host must wait for its data
    return t.to(device, non_blocking=device.type == "cuda")


def make_mesh(devices=None, axis: str = "pix") -> Mesh:
    """1D mesh over the pixel-row axis: every CUDA device by default (raises
    without one), or the given devices in order."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass the devices, e.g. "
                               "[torch.device('cpu')] * 8, to build a mesh on the CPU")
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis)


def shard_rows(mesh: Mesh, data) -> RowSharded:
    """Split (..., H, W) by rows, one contiguous block on each mesh device
    (JAX: ``P(None, axis, None)``). H must divide by the mesh size."""
    if isinstance(data, RowSharded):
        if not data.replicated and data.mesh == mesh:
            return data
        data = data.gather("reshard")
    n = mesh.size
    if data.dim() < 2 or data.shape[-2] % n != 0:
        raise ValueError(f"shard_rows: {tuple(data.shape)} has no row axis that divides "
                         f"over {n} devices")
    rows = data.shape[-2] // n
    blocks = [_to(data[..., k * rows:(k + 1) * rows, :], dev).contiguous()
              for k, dev in enumerate(mesh.devices)]
    if data.device == mesh.lead:
        for b in blocks[1:]:
            _moved("rows", b)
    return RowSharded(mesh, data.shape, blocks)


def replicated(mesh: Mesh, data) -> RowSharded:
    """One copy of data on the lead device (JAX: ``P()``)."""
    data = gather(data, "replicate")
    return RowSharded(mesh, data.shape, [_to(data, mesh.lead)], replicated=True)


def divides(mesh: Mesh, shape) -> bool:
    """Whether a (..., H, W) value of this shape row-shards over the mesh."""
    return len(shape) >= 2 and shape[-2] % mesh.size == 0


def place_on_mesh(data, mesh: Mesh, axis: str = "pix") -> RowSharded:
    """Row-shard an image array of shape (..., H, W) across the mesh; an
    array whose row count does not divide the mesh is replicated (one copy
    on the lead device), as in the JAX package.

    This is the placement of every frame under ``Context.mesh``: the loader
    puts each shard's rows straight on its device (io/fits.py,
    io/ingest.py), and the per-frame operators of the stack path then run
    on each shard's rows, as XLA's sharding propagation runs the JAX
    package's programs: calibrate, bad-pixel repair (a one-row halo), the
    statistics (reductions of per-shard partials, the sampled estimators
    through take_flat), star detection (a halo of 2 x radius rows, the
    candidates merged on the lead), histogram match, the warp (a halo of
    the rows the transform reaches, else the source gathered), and the
    per-pixel stretch operators. Operators that need whole columns or the
    whole grid (the debands, background extraction) take the frame
    gathered and, where they return an image, place it back."""
    if isinstance(data, RowSharded) and data.mesh == mesh:
        if data.replicated == (not divides(mesh, data.shape)):
            return data
    if not divides(mesh, data.shape):
        return replicated(mesh, data)
    return shard_rows(mesh, data)


def map_blocks(fn, x: RowSharded, *args, shape=None) -> RowSharded:
    """fn(block, *args') on each shard's device: a RowSharded argument
    placed like x hands over its own block, another is passed as it is.
    The result has x's placement and shape (or `shape`, with the same row
    split)."""
    def arg(a, k):
        if isinstance(a, RowSharded):
            if a.replicated != x.replicated or len(a.blocks) != len(x.blocks):
                raise ValueError("map_blocks: arguments placed unlike the value")
            return a.blocks[k]
        return a

    blocks = [fn(b, *(arg(a, k) for a in args)) for k, b in enumerate(x.blocks)]
    return RowSharded(x.mesh, x.shape if shape is None else shape, blocks, x.replicated)


def per_block(fn, data):
    """fn on each shard's block of a RowSharded value (map_blocks), or on a
    tensor."""
    return map_blocks(fn, data) if isinstance(data, RowSharded) else fn(data)


def _rows_to(x: RowSharded, start: int, stop: int, device: torch.device) -> list:
    """Global rows [start, stop) of a row-sharded x, copied to `device`: one
    part from each shard that holds some of them, in row order."""
    rows = x.shape[-2] // x.mesh.size
    parts = []
    for j in range(start // rows, -(-stop // rows)):
        lo, hi = max(start, j * rows) - j * rows, min(stop, (j + 1) * rows) - j * rows
        part = x.blocks[j][..., lo:hi, :]
        _moved("halo", part)
        parts.append(_to(part, device))
    return parts


def halo(x: RowSharded, above: int, below: int) -> list:
    """Each shard's block with up to `above` rows before it and `below`
    rows after it, copied to its device from as many neighbouring shards as
    hold them: a list of (rows, top, bottom), `top`/`bottom` the rows
    received. The frame ends the halo: a shard within `above` rows of the
    frame's first row receives only the rows above it (top 0 on the first
    shard), and likewise at the last row; the caller decides what the edge
    means. A replicated value is one block, top and bottom 0."""
    if x.replicated:
        return [(x.blocks[0], 0, 0)]
    h = x.shape[-2]
    rows = h // x.mesh.size
    out = []
    for k, (dev, b) in enumerate(zip(x.mesh.devices, x.blocks)):
        r0 = k * rows
        top, bottom = min(above, r0), min(below, h - r0 - rows)
        parts = [*_rows_to(x, r0 - top, r0, dev), b,
                 *_rows_to(x, r0 + rows, r0 + rows + bottom, dev)]
        out.append((torch.cat(parts, dim=-2) if len(parts) > 1 else b, top, bottom))
    return out


def merge_top_k(parts, n: int, k: int, device: torch.device):
    """The k brightest of per-shard candidate lists, merged on `device`:
    `parts` holds each shard's (values, global flat indices), and the
    result is (values, indices), k of each, ordered by value descending,
    ties by the lower global index, as detect/stars.py _select_brightest
    orders a whole frame's candidates. An entry whose value is -inf (no
    candidate) carries index n - 1, and so does the padding up to k."""
    vals = torch.cat([_to(v, device) for v, _ in parts])
    idx = torch.cat([_to(i, device).to(torch.int64) for _, i in parts])
    idx = torch.where(vals > -math.inf, idx, torch.full((), n - 1, device=device))
    by_index = torch.sort(idx, stable=True).indices
    vals, idx = vals[by_index], idx[by_index]
    by_value = torch.sort(vals, descending=True, stable=True).indices[:k]
    vals, idx = vals[by_value], idx[by_value]
    if vals.shape[0] < k:
        fill = k - vals.shape[0]
        vals = torch.nn.functional.pad(vals, (0, fill), value=-math.inf)
        idx = torch.nn.functional.pad(idx, (0, fill), value=n - 1)
    return vals, idx


def min_max(x: RowSharded):
    """(min, max) over every element as 0-d tensors on the lead device:
    exact, the per-shard extremes compared there."""
    lead = x.mesh.lead
    mns = torch.stack([_to(b.amin(), lead) for b in x.blocks])
    mxs = torch.stack([_to(b.amax(), lead) for b in x.blocks])
    return mns.amin(), mxs.amax()


def sum64(x: RowSharded, fn=None) -> torch.Tensor:
    """Sum over every element of fn(block) (the block itself by default),
    each shard's sum in float64, the partials added on the lead device:
    a 0-d float64 tensor. The unsharded code accumulates in float64 too, so
    a result rounded once to float32 is the same but at a rounding tie."""
    lead = x.mesh.lead
    total = None
    for b in x.blocks:
        v = (b if fn is None else fn(b)).to(torch.float64).sum()
        v = _to(v, lead)
        total = v if total is None else total + v
    return total


def psum(values, mesh: Mesh) -> torch.Tensor:
    """The per-shard counts summed on the lead device (JAX's ``psum``), as
    int64; no value is read back to the host."""
    total = None
    for v in values:
        v = _to(torch.as_tensor(v), mesh.lead).to(torch.int64)
        total = v if total is None else total + v
    return total


# take_flat's routings, newest last: (idx, shape, mesh) -> per shard
# (positions in draw order on the lead, local flat indices on the shard)
_ROUTES: collections.OrderedDict = collections.OrderedDict()


def _route(idx: np.ndarray, shape, mesh: Mesh) -> list:
    """The routing of global flat indices `idx` over the shards of a
    (..., H, W) value, on the devices, kept for the last few index arrays
    (the estimators draw the same indices for every frame of a size)."""
    key = (id(idx), tuple(shape), mesh)
    hit = _ROUTES.get(key)
    if hit is not None and hit[0] is idx:
        _ROUTES.move_to_end(key)
        return hit[1]
    h, w = shape[-2], shape[-1]
    rows = h // mesh.size
    flat = np.asarray(idx, np.int64)
    plane, rest = np.divmod(flat, h * w)
    row, col = np.divmod(rest, w)
    owner = row // rows
    local = (plane * rows + row % rows) * w + col
    routes = []
    for k, dev in enumerate(mesh.devices):
        sel = np.nonzero(owner == k)[0]
        routes.append((torch.from_numpy(sel).to(mesh.lead),
                       torch.from_numpy(local[sel]).to(dev)))
    _ROUTES[key] = (idx, routes)  # holds idx, so its id is not reused
    while len(_ROUTES) > 8:
        _ROUTES.popitem(last=False)
    return routes


def take_flat(x: RowSharded, idx) -> torch.Tensor:
    """x.reshape(-1)[idx] on the lead device, in the order of `idx` (global
    flat indices, a numpy array): each index is routed to the shard that
    owns its row, each shard gathers its own, and the values are put in
    draw order on the lead."""
    if x.replicated:
        return x.blocks[0].reshape(-1)[torch.tensor(idx, dtype=torch.int64,
                                                    device=x.blocks[0].device)]
    lead = x.mesh.lead
    out = torch.empty(len(idx), dtype=x.dtype, device=lead)
    for b, (sel, local) in zip(x.blocks, _route(idx, x.shape, x.mesh)):
        if sel.numel():
            out[sel] = _to(b.reshape(-1)[local], lead)
    return out


def sharded_star_detect(mesh: Mesh, radius: int = 16, max_candidates: int = 2048,
                        axis: str = "pix"):
    """Star detection over a row-sharded image. Returns the callable (img,
    location, scale, star_sig, bp_sig, star_in_out, median_diff_std) ->
    (StarList, average HFR).

    JAX partitions the detector over the mesh, its global reductions
    becoming collectives. The port splits it the same way
    (detect/stars.py find_stars_sharded): each shard finds and ranks the
    candidates of its rows on a block with a halo of 2 x radius rows, the
    lists are merged on the lead (merge_top_k), each shard takes the
    bad-pixel test and K4's patches of the candidates whose centre row it
    holds, and the lead runs the overlap filters, the centre of mass and
    the HFR on the patches it receives. No frame is gathered."""
    from nightlight_tpu_torch.detect.stars import find_stars_sharded

    def fn(img, location, scale, star_sig, bp_sig, star_in_out, median_diff_std):
        return find_stars_sharded(place_on_mesh(img, mesh, axis), float(location),
                                  float(scale), float(star_sig), float(bp_sig),
                                  float(star_in_out), radius,
                                  None if median_diff_std is None else float(median_diff_std),
                                  max_candidates)

    return fn


def sharded_auto_stretch(mesh: Mesh, max_iter: int = 50, axis: str = "pix"):
    """The iterative auto-stretch of a row-sharded image. Returns the
    callable (data, target_loc, target_scale) -> (stretched, history,
    n_iter, converged), the stretched image row-sharded.

    As JAX turns the per-round statistics into psums, each round reads its
    statistics from the shards (min_max, sum64, the sampled estimator
    through take_flat) and the lead decides; the gamma or black-point
    transform then runs on each shard's block (ops/autostretch.py)."""
    from nightlight_tpu_torch.ops.autostretch import auto_stretch

    def fn(data, target_loc, target_scale):
        return auto_stretch(place_on_mesh(data, mesh, axis), target_loc, target_scale,
                            max_iter=max_iter)

    return fn
