"""Device mesh and sharded pipeline steps, mirror of
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
  ``ppermute`` in the step functions below sends zeros, as JAX's does to a
  shard without a source;
* ``take_flat`` gathers single pixels at global flat indices from the
  shards that own them; ``merge_top_k`` merges per-shard top-k lists on
  the lead;
* an all-gather is ``torch.cat`` of the blocks on the lead device
  (``RowSharded.gather``), counted per asking site in ``GATHERS``.

Under ``Context.mesh`` every loaded frame is row-sharded at load
(``place_on_mesh``; io/fits.py and io/ingest.py upload each shard's rows
straight to its device), and the per-frame operators of the ``stack`` path
run on each shard's rows: calibrate, bad-pixel repair, statistics, star
detection (``sharded_star_detect``), histogram match and the warp
(ops/resample.py). ``OpStack`` stacks each device's blocks into its block
of the batch cube, and the stacked image stays row-sharded through the
final detection and the per-pixel stretch operators; the writers gather.

A device may appear more than once in a mesh: the CPU tests run 8 shards on
the CPU (``make_mesh([torch.device("cpu")] * 8)``, beside JAX's 8 virtual
CPU devices), and ``chip_smoke.py`` runs 4 shards on one card. Each shard's
stack launches its kernel (K1, K2 or K3) on its own device.

Where JAX jits a step with shardings and returns the compiled function, the
port returns a plain callable with the same arguments and results (the
``axis`` arguments are kept for that; a value's axis name is its mesh's). The
calibrate / match / warp arithmetic is element-wise work that XLA fuses, so
it stays plain PyTorch, with ``ops/pixelmath.py:fma32`` where XLA contracts
``a*b + c``. Every per-pixel result is the same wherever it runs, so a
sharded step equals the unsharded one bit for bit (the halo warp: where the
halo covers the displacement).
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass

import numpy as np
import torch

from nightlight_tpu_torch import trace
from nightlight_tpu_torch.ops import stack as stk
from nightlight_tpu_torch.ops.pixelmath import _f32, fma32


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

# the most rows a shard takes from each neighbour for a warp by halo
# exchange (sharded_full_pipeline_step_auto; the batch planner counts it
# on every frame's shard)
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


def _calibrate_match(frames, dark, flat, flat_max, ref_locs, ref_scales, loc0, scale0):
    """Dark and flat calibration (pre/preprocess.go:68-99) and the per-frame
    linear histogram match (pixelops.go:601-611) of (N, rows, W) frames,
    one frame at a time (the temporaries stay one frame in size)."""
    mult = _f32(ref_scales, frames) / _f32(scale0, frames)
    off = fma32(-_f32(loc0, frames), mult, _f32(ref_locs, frames))
    flat_max = _f32(flat_max, frames)
    out = torch.empty_like(frames)
    for i in range(frames.shape[0]):
        cal = frames[i] - dark
        cal = torch.where(flat <= 0.0, cal, cal * flat_max / flat)
        out[i] = fma32(cal, mult[i], off[i])
    return out


def _warp_frames(frames, invs, row0: int = 0, rows: int | None = None,
                 dest_h: int | None = None, src_row0: int = 0):
    """Per-frame affine bilinear warp with NaN out-of-bounds fill (the
    alignment phase, internal/fits/project.go:26-76). invs: (N, 6) inverse
    transforms [a, b, c, d, e, f].

    Called as the JAX function, (frames, invs), it warps whole frames. A
    shard warps its destination rows [row0, row0 + rows) of a dest_h-row
    frame from a source block whose first row is global row src_row0: the
    whole gathered frame (src_row0 0) or its block between the received
    halos; a source row outside the block is missing data (NaN), as a pixel
    out of the frame is."""
    n, src_rows, w = frames.shape
    dest_h = src_rows if dest_h is None else dest_h
    rows = dest_h - row0 if rows is None else rows
    dev = frames.device
    invs = _f32(np.asarray(invs, np.float32).reshape(-1, 6), frames)
    col = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    row = (row0 + torch.arange(rows, device=dev)).to(torch.float32)[:, None]
    nan = torch.tensor(float("nan"), device=dev)
    out = torch.empty((n, rows, w), dtype=torch.float32, device=dev)
    for i in range(n):
        inv = invs[i]
        # the multiply-adds as XLA's CPU code contracts them in the jitted
        # JAX steps (held bit for bit by tests/test_torch_mesh.py)
        px = fma32(inv[0], col, inv[1] * row) + inv[2]
        py = fma32(inv[3], col, inv[4] * row) + inv[5]
        xl = torch.floor(px)
        yl = torch.floor(py)
        xr = px - xl
        yr = py - yl
        xl_i = xl.to(torch.int64)
        yl_i = yl.to(torch.int64)
        # global out-of-bounds (project.go:52-61), or beyond the source block
        yl_loc = yl_i - src_row0
        oob = ((xl_i < 0) | (xl_i + 1 >= w) | (yl_i < 0) | (yl_i + 1 >= dest_h)
               | (yl_loc < 0) | (yl_loc + 1 >= src_rows))
        xc = xl_i.clamp(0, w - 2)
        yc = yl_loc.clamp(0, src_rows - 2)
        img = frames[i]
        v00 = img[yc, xc]
        v01 = img[yc, xc + 1]
        v10 = img[yc + 1, xc]
        v11 = img[yc + 1, xc + 1]
        top = fma32(v00, 1 - xr, v01 * xr)
        bottom = fma32(v10, 1 - xr, v11 * xr)
        out[i] = torch.where(oob, nan, fma32(top, 1 - yr, bottom * yr))
    return out


def _pipeline_step(frames, dark, flat, flat_max, weights, ref_locs, ref_scales,
                   loc0, scale0, sigma_low, sigma_high, mode: int,
                   mesh: Mesh | None = None, axis: str = "pix"):
    """One fused training-step analog: calibrate every frame, match
    histograms to the reference, and reduce the frame axis with the
    configured outlier-rejection stack. With `mesh` set the stack runs
    row-sharded (ops/stack.py stack_sharded: each shard's kernel on its
    device, the clip counts summed)."""
    matched = _calibrate_match(gather(frames), gather(dark), gather(flat), flat_max,
                               ref_locs, ref_scales, loc0, scale0)
    return stk.stack(matched, stk.StackMode(mode), weights=weights,
                     sigma_low=float(sigma_low), sigma_high=float(sigma_high),
                     ref_frame_loc=float(loc0), mesh=mesh, axis=axis)


def _full_pipeline_step(frames, dark, flat, flat_max, weights, ref_locs, ref_scales,
                        loc0, scale0, invs, sigma_low, sigma_high, mode: int,
                        mesh: Mesh | None = None, axis: str = "pix"):
    """The complete per-batch program: calibrate + histogram-match +
    align-warp + outlier-rejection stack, unsharded up to the stack; with
    `mesh` set the stack runs row-sharded (see _pipeline_step)."""
    matched = _calibrate_match(gather(frames), gather(dark), gather(flat), flat_max,
                               ref_locs, ref_scales, loc0, scale0)
    warped = _warp_frames(matched, invs)
    del matched
    return stk.stack(warped, stk.StackMode(mode), weights=weights,
                     sigma_low=float(sigma_low), sigma_high=float(sigma_high),
                     ref_frame_loc=float(loc0), mesh=mesh, axis=axis)


def _sharded_calibrate_match(mesh, frames, dark, flat, flat_max, ref_locs, ref_scales,
                             loc0, scale0) -> RowSharded:
    """Calibrate and match each shard's rows on its device."""
    frames, dark, flat = (shard_rows(mesh, x) for x in (frames, dark, flat))
    blocks = [_calibrate_match(fb, db, lb, flat_max, ref_locs, ref_scales, loc0, scale0)
              for fb, db, lb in zip(frames.blocks, dark.blocks, flat.blocks)]
    return RowSharded(mesh, frames.shape, blocks)


def _stack_step(mesh, mode, warped: RowSharded, weights, loc0, sigma_low, sigma_high):
    return stk.stack_sharded(warped, mesh, stk.StackMode(mode), weights=weights,
                             sigma_low=float(sigma_low), sigma_high=float(sigma_high),
                             ref_frame_loc=float(loc0))


def _warp_frames_halo(frames, invs, mesh: Mesh, halo: int, axis: str = "pix") -> RowSharded:
    """Row-sharded affine warp with HALO EXCHANGE instead of a gather: each
    shard receives its neighbours' boundary rows (2 x halo x W words a
    frame) and warps locally, instead of all-gathering whole frames.
    Alignment displacements in stacking are small (a few pixels of
    dither), so a fixed halo covers them; source pixels beyond the halo
    produce NaN -- the same missing-data protocol as out-of-bounds pixels,
    which the stacker already skips.

    frames: (N, H, W) RowSharded over the mesh. invs: (N, 6)."""
    frames = shard_rows(mesh, frames)
    n_shards = mesh.size
    n, h, w = frames.shape
    rows_per = h // n_shards
    blocks = frames.blocks
    out = []
    for k, (dev, fl) in enumerate(zip(mesh.devices, blocks)):
        # the ppermutes: my bottom rows -> next shard's top halo, my top
        # rows -> previous shard's bottom halo; a shard without a source
        # receives zeros
        top = blocks[k - 1][:, -halo:, :] if k > 0 else None
        bot = blocks[k + 1][:, :halo, :] if k + 1 < n_shards else None
        for part in (top, bot):
            if part is not None:
                _moved("halo", part)
        recv_top = (_to(top, dev) if top is not None
                    else torch.zeros_like(fl[:, -halo:, :]))
        recv_bot = (_to(bot, dev) if bot is not None
                    else torch.zeros_like(fl[:, :halo, :]))
        padded = torch.cat([recv_top, fl, recv_bot], dim=1)  # (N, halo+rows+halo, W)
        start = k * rows_per  # first global row of my block
        out.append(_warp_frames(padded, invs, row0=start, rows=rows_per, dest_h=h,
                                src_row0=start - halo))
    return RowSharded(mesh, frames.shape, out)


def sharded_full_pipeline_step_halo(mesh: Mesh, mode: int = int(stk.StackMode.Sigma),
                                    halo: int = 32, axis: str = "pix"):
    """Like sharded_full_pipeline_step, but the warp exchanges halo rows
    with the neighbouring shards instead of gathering frames: the copies
    per frame drop from O(H x W) to O(2 x halo x W). The stack reduction
    runs per shard (the kernels on each shard's device)."""

    def step(frames, dark, flat, flat_max, weights, ref_locs, ref_scales,
             loc0, scale0, invs, sigma_low, sigma_high):
        matched = _sharded_calibrate_match(mesh, frames, dark, flat, flat_max, ref_locs,
                                           ref_scales, loc0, scale0)
        warped = _warp_frames_halo(matched, invs, mesh, halo, axis)
        del matched
        return _stack_step(mesh, mode, warped, weights, loc0, sigma_low, sigma_high)

    return step


def required_halo(invs, dest_h: int, dest_w: int) -> int:
    """Smallest halo (in rows) that lets every destination pixel of every
    frame read its bilinear source rows locally under the given inverse
    transforms: max |py - y| over the destination corners, plus 1 for the
    bilinear +1 neighbor. Affine transforms attain their extreme row
    displacement at a corner, so checking the 4 corners is exact."""
    invs = np.asarray(invs, np.float64).reshape(-1, 6)
    corners = [(0.0, 0.0), (dest_w - 1.0, 0.0), (0.0, dest_h - 1.0),
               (dest_w - 1.0, dest_h - 1.0)]
    worst = 0.0
    for inv in invs:
        for (x, y) in corners:
            py = inv[3] * x + inv[4] * y + inv[5]
            worst = max(worst, abs(py - y))
    return int(math.floor(worst)) + 2


def sharded_full_pipeline_step_auto(mesh: Mesh, invs,
                                    mode: int = int(stk.StackMode.Sigma),
                                    dest_h: int = 0, dest_w: int = 0,
                                    halo_cap: int = HALO_CAP, axis: str = "pix", log=None):
    """Pick the warp strategy from the batch's ACTUAL transforms: the
    halo-exchange warp with a halo sized to the largest row displacement
    (bucketed to powers of two), or the gather-warp step when the
    displacement exceeds `halo_cap` rows.

    The fixed-halo step silently NaNs rows whose source lies beyond the
    halo (the stacker then treats them as missing data) -- a frame with a
    40 px dither would quietly lose rows. This dispatcher makes that
    impossible for host-known transforms: the halo always covers the batch
    or the gather path takes over. Returns the step function."""
    need = required_halo(invs, dest_h, dest_w)
    if need > halo_cap:
        if log is not None:
            log.write(f"Halo warp: displacement needs {need} rows > cap "
                      f"{halo_cap}; using the gather-warp step\n")
        return sharded_full_pipeline_step(mesh, mode, axis=axis)
    halo = 8
    while halo < need:
        halo *= 2
    rows_per = dest_h // mesh.size if dest_h else halo
    halo = min(halo, max(rows_per, 1))
    if halo < need:
        # shard blocks are shorter than the needed halo: exchange cannot
        # reach far enough, use the gather step
        if log is not None:
            log.write(f"Halo warp: displacement {need} exceeds shard height "
                      f"{rows_per}; using the gather-warp step\n")
        return sharded_full_pipeline_step(mesh, mode, axis=axis)
    if log is not None:
        log.write(f"Halo warp: exchanging {halo} boundary rows "
                  f"(batch needs {need})\n")
    return sharded_full_pipeline_step_halo(mesh, mode, halo=halo, axis=axis)


def sharded_full_pipeline_step(mesh: Mesh, mode: int = int(stk.StackMode.Sigma),
                               axis: str = "pix"):
    """The calibrate+match+warp+stack step row-sharded over the mesh: each
    shard calibrates and matches its rows; the warp all-gathers the matched
    frames (a pixel's source may lie in any shard) and each shard warps its
    own destination rows; the stack runs per shard. Returns the step
    function."""

    def step(frames, dark, flat, flat_max, weights, ref_locs, ref_scales,
             loc0, scale0, invs, sigma_low, sigma_high):
        matched = _sharded_calibrate_match(mesh, frames, dark, flat, flat_max, ref_locs,
                                           ref_scales, loc0, scale0)
        full = matched.gather()
        del matched
        n, h, w = full.shape
        rows = h // mesh.size
        blocks = [_warp_frames(_to(full, dev), invs, row0=k * rows, rows=rows)
                  for k, dev in enumerate(mesh.devices)]
        del full
        warped = RowSharded(mesh, (n, h, w), blocks)
        return _stack_step(mesh, mode, warped, weights, loc0, sigma_low, sigma_high)

    return step


def _place_inputs(mesh: Mesh, frames, dark, flat):
    """Host frames, dark and flat row-sharded over the mesh, the flat's
    maximum, and a vector of N ones (the weights and the reference
    locations and scales of run_sharded_*)."""
    placed = [shard_rows(mesh, torch.from_numpy(np.ascontiguousarray(a, np.float32)))
              for a in (frames, dark, flat)]
    ones = _to(torch.ones(frames.shape[0], dtype=torch.float32), mesh.lead)
    return (*placed, float(np.float32(flat.max())), ones)


def run_sharded_full_stack(frames: np.ndarray, dark: np.ndarray, flat: np.ndarray,
                           invs: np.ndarray, mesh: Mesh | None = None,
                           mode: int = int(stk.StackMode.Sigma),
                           sigma_low: float = 2.75, sigma_high: float = 2.75):
    """Place host frames on the mesh and run one full calibrate+match+warp+
    stack step. invs: (N, 6) inverse alignment transforms."""
    if mesh is None:
        mesh = make_mesh()
    fn = sharded_full_pipeline_step(mesh, mode)
    dev_frames, dark_s, flat_s, flat_max, ones = _place_inputs(mesh, frames, dark, flat)
    return fn(dev_frames, dark_s, flat_s, flat_max, ones, ones, ones, 1.0, 1.0,
              invs, sigma_low, sigma_high)


def sharded_pipeline_step(mesh: Mesh, mode: int = int(stk.StackMode.Sigma),
                          axis: str = "pix"):
    """The calibrate+match+stack step row-sharded over the mesh: each shard
    calibrates and matches its rows, then runs its stack kernel on them.
    Returns the step function."""

    def step(frames, dark, flat, flat_max, weights, ref_locs, ref_scales, loc0, scale0,
             sigma_low, sigma_high):
        matched = _sharded_calibrate_match(mesh, frames, dark, flat, flat_max, ref_locs,
                                           ref_scales, loc0, scale0)
        return _stack_step(mesh, mode, matched, weights, loc0, sigma_low, sigma_high)

    return step


def run_sharded_stack(frames: np.ndarray, dark: np.ndarray, flat: np.ndarray,
                      mesh: Mesh | None = None, mode: int = int(stk.StackMode.Sigma),
                      sigma_low: float = 2.75, sigma_high: float = 2.75):
    """Convenience wrapper: place host frames on the mesh and run one step."""
    if mesh is None:
        mesh = make_mesh()
    fn = sharded_pipeline_step(mesh, mode)
    dev_frames, dark_s, flat_s, flat_max, ones = _place_inputs(mesh, frames, dark, flat)
    return fn(dev_frames, dark_s, flat_s, flat_max, ones, ones, ones, 1.0, 1.0,
              sigma_low, sigma_high)
