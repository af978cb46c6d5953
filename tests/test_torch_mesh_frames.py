"""Row-sharded frames under the port's device mesh: each frame placed on the
mesh by rows at load, and calibrate, bad-pixel repair, the statistics,
histogram match, the warp, debayer and binning run on each shard's rows
(nightlight_tpu_torch/parallel/mesh.py place_on_mesh), held against the
unsharded port and against the JAX package's sharded run (its
place_on_mesh and XLA's sharding propagation, on the 8 virtual CPU
devices that tests/conftest.py forces).

The port side runs 8 shards on the CPU (``make_mesh([cpu] * 8)``) on 256²
frames (32 rows a shard) made from a seed with numpy. Tolerances:

* sharded against unsharded port: bit for bit (images, NaN placement,
  every statistic, counts), log line for line. The float64 partial sums
  of the mean and the stddevs round to the same float32 as the unsharded
  float64 sums but at a rounding tie; no case here hits one (each test
  that compares them asserts equality).
* against the JAX package's sharded run: tests/test_mesh.py's band for
  whole jobs (rtol 1e-4, atol 1e-3 on at least 90% of the finite pixels),
  equal star and bad-pixel counts, the clip totals within
  tests/test_torch_cli.py's band (a sample within ~1e-5 px of a clip bound
  flips, the transforms coming from centroid sums in another order); per
  module the bands stated at each test.
"""

import contextlib
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightlight_tpu.parallel import mesh as jm
from nightlight_tpu_torch.parallel import mesh as tm

torch.set_num_threads(1)

CPU = torch.device("cpu")
H = W = 256


@pytest.fixture(scope="module")
def mesh():
    return tm.make_mesh([CPU] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return jm.make_mesh()


def _np(x):
    return tm.gather(x).numpy()


def _sky(rng, h=H, w=W, hot=()):
    """Noise about 100 with a few hot and cold pixels at the given rows."""
    img = rng.normal(100.0, 2.0, size=(h, w)).astype(np.float32)
    for i, r in enumerate(hot):
        img[r, (37 * i + 11) % w] += 400.0 if i % 2 == 0 else -300.0
    return img


def _sharded(mesh, a):
    return tm.place_on_mesh(torch.from_numpy(np.ascontiguousarray(a)), mesh)


def _band(a, b, rtol=1e-4, atol=1e-3, share=0.9):
    """tests/test_mesh.py's band: at least `share` of the port's finite
    pixels finite in both, and those within rtol/atol."""
    m = np.isfinite(a) & np.isfinite(b)
    assert m.sum() >= share * np.isfinite(a).sum()
    np.testing.assert_allclose(a[m], b[m], rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# parallel/mesh.py: the primitives
# ---------------------------------------------------------------------------


def test_place_on_mesh_rows_and_replication(mesh, jmesh, rng):
    """A frame whose rows divide the mesh holds one (32, 256) block per
    device, in row order; 250 rows do not divide 8 and the frame is one
    replicated copy on the lead device, as in the JAX package."""
    img = _sky(rng)
    x = _sharded(mesh, img)
    assert not x.replicated and [tuple(b.shape) for b in x.blocks] == [(32, 256)] * 8
    assert x.row0s == [32 * k for k in range(8)]
    np.testing.assert_array_equal(_np(x), img)
    assert not jm.place_on_mesh(jnp.asarray(img), jmesh).sharding.is_fully_replicated
    odd = _sharded(mesh, img[:250])
    assert odd.replicated and len(odd.blocks) == 1 and odd.spec == ()
    assert jm.place_on_mesh(jnp.asarray(img[:250]), jmesh).sharding.is_fully_replicated


@pytest.mark.parametrize("above,below", [(2, 1), (33, 70), (0, 8), (32, 32), (224, 0)])
def test_halo_rows_and_frame_edges(mesh, rng, above, below):
    """halo copies the neighbours' boundary rows; the frame's first and last
    shards receive none on their outer side (a flag, not zeros). A halo
    taller than a shard takes its rows from as many shards as it spans (33
    rows above: two shards; 70 below: three; 224 above: every shard before
    the last), up to the frame's edge; a side of 0 rows receives nothing,
    and a shard that receives no row keeps its own block."""
    img = _sky(rng)
    x = _sharded(mesh, img)
    for k, (ext, top, bottom) in enumerate(tm.halo(x, above, below)):
        assert (top, bottom) == (min(above, 32 * k), min(below, 224 - 32 * k))
        np.testing.assert_array_equal(ext.numpy(), img[32 * k - top:32 * k + 32 + bottom])
        assert (ext is x.blocks[k]) == (top == bottom == 0)


def test_reductions_and_psum(mesh, rng):
    """min and max exact; the float64 partial sums equal the float64 sum of
    the whole frame when rounded to float32; counts are int64."""
    img = _sky(rng, hot=(0, 31, 32, 255))
    x = _sharded(mesh, img)
    mn, mx = tm.min_max(x)
    assert (float(mn), float(mx)) == (float(img.min()), float(img.max()))
    whole = torch.from_numpy(img).to(torch.float64).sum()
    assert float(tm.sum64(x).to(torch.float32)) == float(whole.to(torch.float32))
    counts = tm.psum([torch.tensor(3, dtype=torch.int32)] * 8, mesh)
    assert counts.dtype == torch.int64 and int(counts) == 24


def test_take_flat_in_draw_order(mesh, rng):
    """take_flat at the -lsEst 3 estimator's draws equals the unsharded
    _sample of the whole flat frame, in draw order, and so do the MAD
    draws; a replicated frame is taken from its one copy."""
    from nightlight_tpu_torch.ops import stats as tst

    img = _sky(rng)
    x = _sharded(mesh, img)
    for idx in (tst._scmq_draws(H * W, tst.NUM_SAMPLES, 10)[0],
                tst._sample_idx(H * W, tst.NUM_SAMPLES, 1)):
        want = tst._sample(torch.from_numpy(img).reshape(1, -1), idx)[0]
        assert torch.equal(tm.take_flat(x, idx), want)
    odd = img[:250]
    idx = tst._sample_idx(odd.size, 4096, 0)
    assert torch.equal(tm.take_flat(_sharded(mesh, odd), idx),
                       torch.from_numpy(odd).reshape(-1)[torch.tensor(idx)])


# ---------------------------------------------------------------------------
# ops/stats.py: Stats on a RowSharded frame
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_stats_sharded(mesh, jmesh, rng, mode):
    """Every -lsEst estimator on a row-sharded frame equals the unsharded
    one bit for bit (min, max, mean, stddev, location, scale, noise), and
    the JAX package's Stats of its sharded frame: min/max exactly, the
    others to 1e-5 relative (XLA's float32 sums run in another order)."""
    from nightlight_tpu.ops import stats as jst
    from nightlight_tpu_torch.ops import stats as tst

    img = _sky(rng) + np.linspace(0, 30, W, dtype=np.float32)[None, :]
    su = tst.Stats(torch.from_numpy(img), W, mode)
    ss = tst.Stats(_sharded(mesh, img), W, mode)
    keys = ("min", "max", "mean", "stddev", "location", "scale", "noise")
    got = {k: getattr(ss, k) for k in keys}
    assert got == {k: getattr(su, k) for k in keys}
    js = jst.Stats(jm.place_on_mesh(jnp.asarray(img), jmesh), W, jst.LSEstimatorMode(mode))
    assert (got["min"], got["max"]) == (float(js.min), float(js.max))
    for k in keys[2:]:
        assert got[k] == pytest.approx(float(getattr(js, k)), rel=1e-5, abs=1e-6), k


# ---------------------------------------------------------------------------
# ops/prestack.py: calibrate, bad-pixel repair, debayer, bayer correction
# ---------------------------------------------------------------------------


def test_bad_pixel_repair_halo_and_edges(mesh, jmesh, rng):
    """Hot and cold pixels on the rows either side of every shard boundary
    and on the frame's first and last rows: the sharded repair equals the
    unsharded one bit for bit (the first and last rows pass through, as
    the 3x3 median does), with the same count and stddev; against the JAX
    package's repair of its sharded frame, the count is equal and the
    image within 1e-6 (its stddev reduces in another order)."""
    from nightlight_tpu.ops import prestack as jps
    from nightlight_tpu_torch.ops import prestack as tps

    hot = [0, 255] + [r for k in range(1, 8) for r in (32 * k - 1, 32 * k)]
    img = _sky(rng, hot=hot)
    rep_u, n_u, std_u = tps.bad_pixel_repair(torch.from_numpy(img), 3.0, 5.0)
    rep_s, n_s, std_s = tps.bad_pixel_repair_sharded(_sharded(mesh, img), 3.0, 5.0)
    assert isinstance(rep_s, tm.RowSharded) and len(rep_s.blocks) == 8
    np.testing.assert_array_equal(_np(rep_s), rep_u.numpy())
    assert int(n_s) == int(n_u) and n_s.dtype == torch.int64 and float(std_s) == float(std_u)
    assert int(n_u) >= len(hot) - 2  # the boundary pixels were found and repaired
    np.testing.assert_array_equal(rep_u.numpy()[[0, 255]], img[[0, 255]])
    rep_j, n_j, _ = jps.bad_pixel_repair(jm.place_on_mesh(jnp.asarray(img), jmesh), 3.0, 5.0)
    assert int(n_j) == int(n_s)
    np.testing.assert_allclose(_np(rep_s), np.asarray(rep_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("args", [(101.5, 2.25, 1000.0, 20.0), (1.0, 1.0, 1.0, 1.0)],
                         ids=["match", "unit"])
def test_calibrate_and_match_per_shard(mesh, jmesh, rng, args):
    """Dark subtraction, flat division (zero flat pixels pass through) and
    the location/scale match of a sharded frame, block by block with the
    masters sharded alike: bit for bit the unsharded functions, and bit for
    bit the JAX package's jitted functions on its sharded frame (the match
    rounds its multiply-adds once, as XLA contracts them: ops/pixelmath.py
    fma32). The unit match, x*1+0, returns the calibrated frame as it is."""
    from nightlight_tpu.ops import pixelmath as jpm
    from nightlight_tpu.ops import prestack as jps
    from nightlight_tpu_torch.ops import pixelmath as tpm
    from nightlight_tpu_torch.ops import prestack as tps

    img, dark = _sky(rng), rng.normal(5.0, 0.2, size=(H, W)).astype(np.float32)
    flat = rng.uniform(0.8, 1.0, size=(H, W)).astype(np.float32)
    flat[[0, 31, 32, 200], [5, 6, 7, 8]] = 0.0
    fmax = float(flat.max())
    x, d, f = (_sharded(mesh, a) for a in (img, dark, flat))
    cal = tm.map_blocks(lambda b, fl: tps.flat_divide(b, fl, fmax),
                        tm.map_blocks(tps.subtract, x, d), f)
    want = tps.flat_divide(torch.from_numpy(img) - torch.from_numpy(dark),
                           torch.from_numpy(flat), fmax)
    np.testing.assert_array_equal(_np(cal), want.numpy())
    jx, jd, jf = (jm.place_on_mesh(jnp.asarray(a), jmesh) for a in (img, dark, flat))
    jcal = jps.flat_divide(jps.subtract(jx, jd), jf, jnp.float32(fmax))
    np.testing.assert_array_equal(_np(cal), np.asarray(jcal))
    got = tm.per_block(lambda b: tpm.match_histogram(b, *args), cal)
    np.testing.assert_array_equal(_np(got), tpm.match_histogram(want, *args).numpy())
    if args == (1.0, 1.0, 1.0, 1.0):
        np.testing.assert_array_equal(_np(got), want.numpy())
    jgot = np.asarray(jpm.match_histogram(jcal, *(jnp.float32(a) for a in args)))
    np.testing.assert_array_equal(_np(got), jgot)


@pytest.mark.parametrize("cfa", ["RGGB", "GRBG", "GBRG", "BGGR"])
@pytest.mark.parametrize("channel", ["R", "G", "B"])
def test_debayer_and_bayer_correction_sharded(mesh, jmesh, rng, cfa, channel):
    """The CFA cosmetic correction and the debayer of a sharded mosaic
    equal the unsharded ones bit for bit: per shard with two halo rows
    where the output keeps the input's rows (a CFA row offset of 0), else
    on the gathered mosaic, the result placed by the mesh's rule (a row
    offset of 1 leaves 254 rows, replicated). Against the JAX package's
    debayer of its sharded mosaic: bit for bit."""
    from nightlight_tpu.ops import prestack as jps
    from nightlight_tpu_torch.ops import prestack as tps

    img = _sky(rng, hot=(1, 31, 32, 64, 254))
    x = _sharded(mesh, img)
    cor_u, n_u = tps.cosmetic_correction_bayer(torch.from_numpy(img), channel, cfa, 3.0, 5.0)
    cor_s, n_s = tps.cosmetic_correction_bayer_sharded(x, channel, cfa, 3.0, 5.0)
    np.testing.assert_array_equal(_np(cor_s), cor_u.numpy())
    assert int(n_s) == int(n_u) and not cor_s.replicated
    deb_u = tps.debayer_bilinear(cor_u, channel, cfa)
    deb_s = tps.debayer_sharded(cor_s, channel, cfa)
    np.testing.assert_array_equal(_np(deb_s), deb_u.numpy())
    assert deb_s.replicated == (tps.cfa_offsets(cfa)[1] != 0)
    deb_j = jps.debayer_bilinear(jm.place_on_mesh(jnp.asarray(cor_u.numpy()), jmesh),
                                 channel, cfa)
    np.testing.assert_array_equal(_np(deb_s), np.asarray(deb_j))


def test_bin_sharded(mesh, rng):
    """2x2 binning per shard (32 rows bin to 16) and 3x3 binning, whose
    blocks straddle the shards, on the gathered frame (85 rows are
    replicated): both equal the unsharded binning."""
    from nightlight_tpu_torch.image import Image, bin_nxn

    img = _sky(rng)
    for n, replicated in ((2, False), (3, True)):
        u = bin_nxn(Image.from_numpy(img), n)
        s = bin_nxn(Image.from_naxisn([W, H], _sharded(mesh, img)), n)
        assert s.naxisn == u.naxisn and s.data.replicated == replicated
        np.testing.assert_array_equal(_np(s.data), u.data.numpy())


# ---------------------------------------------------------------------------
# ops/resample.py: the warp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trans,path", [
    ([1.0, 0.0, 3.25, 0.0, 1.0, -2.6], "halo"),  # the shift-blend plan, a halo
    ([0.999, -0.02, 4.0, 0.02, 0.999, 1.5], "halo"),  # a small rotation, shift-blend
    ([0.995, -0.1, 10.0, 0.1, 0.995, -45.0], "warp"),  # the gather warp, beyond the halo
    ([1.0, 0.0, 2.0, 0.0, 1.0, 40.0], "warp"),  # 40 rows: more than a shard's 32
    ([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], "halo"),  # the identity
    ([1.0, 0.0, 0.37, 0.0, 1.0, 0.0], "halo"),  # a sub-pixel shift along x alone
    ([1.0, 0.0, 0.0, 0.0, 1.0, 20.0], "halo"),  # 20 rows: within a shard's 32
    ([1.0, 0.0, 0.0, 0.0, 1.0, 300.0], "warp"),  # the frame left entirely
])
def test_project_sharded(mesh, jmesh, rng, trans, path):
    """project() of a sharded frame equals the unsharded projection bit for
    bit, NaNs in the same places (never a NaN where the unsharded warp has
    a value); the source comes from a halo where the displacement fits a
    shard's rows and is gathered ("warp") where it does not. A shift past
    the frame's height leaves every pixel NaN. Against the JAX package's
    projection of its sharded frame: its band (the port's px/py round apart
    from XLA's contractions)."""
    from nightlight_tpu.ops import resample as jrs
    from nightlight_tpu_torch.ops import resample as trs

    img = _sky(rng)
    img[100, 100] = np.nan  # a missing pixel spreads to its neighbours alike
    trans = np.array(trans, np.float32)
    want = trs.project(torch.from_numpy(img), [W, H], trans, float("nan")).numpy()
    tm.GATHERS.clear()
    got = trs.project(_sharded(mesh, img), [W, H], trans, float("nan"))
    assert isinstance(got, tm.RowSharded) and not got.replicated
    assert dict(tm.GATHERS) == ({} if path == "halo" else {"warp": 1})
    np.testing.assert_array_equal(_np(got), want)
    if abs(trans[5]) >= H:
        assert np.isnan(want).all()
    else:
        assert np.isfinite(want).mean() > 0.5
    j = np.asarray(jrs.project(jm.place_on_mesh(jnp.asarray(img), jmesh), [W, H], trans,
                               float("nan")))
    _band(_np(got), j)


@pytest.mark.parametrize("w,theta", [(W, 0.05), (4096, 0.005)])
def test_gather_warp_from_a_halo(mesh, rng, w, theta):
    """A rotation beyond the shift-blend plan, within a shard's rows: each
    shard's gather warp reads from a halo of the rows that _source_rows
    estimates from the four corners, up to 4096 columns wide (where py
    rounds coarsest); _warp raises if an in-bounds pixel reads a row the
    block lacks, so a bit-for-bit result shows the estimate covered every
    read."""
    from nightlight_tpu_torch.ops import resample as trs

    img = _sky(rng, w=w)
    c, s = np.cos(theta), np.sin(theta)
    trans = np.array([c, -s, 3.3, s, c, -2.7], np.float32)
    assert trs._shift_plan(trs.tf.invert(trans), (H, w), [w, H]) is None
    want = trs.project(torch.from_numpy(img), [w, H], trans, float("nan")).numpy()
    tm.GATHERS.clear()
    got = trs.project(_sharded(mesh, img), [w, H], trans, float("nan"))
    assert dict(tm.GATHERS) == {}
    np.testing.assert_array_equal(_np(got), want)
    assert np.isfinite(want).mean() > 0.5


def test_gather_warp_refuses_a_short_block(rng):
    """_warp given a block that lacks a row an in-bounds pixel reads raises,
    and does not read a clamped row in its place."""
    from nightlight_tpu_torch.ops import resample as trs

    img = torch.from_numpy(_sky(rng))
    inv = np.array([1.0, 0.0, 0.5, 0.0, 1.0, 3.5], np.float32)  # reads 3-4 rows below
    ok = trs._warp(img[32:72], inv, float("nan"), H, W, row0=32, rows=32, src_row0=32,
                   src_h=H)
    np.testing.assert_array_equal(ok.numpy(), trs._warp(img, inv, float("nan"), H, W)[32:64])
    with pytest.raises(ValueError, match="outside the block"):
        trs._warp(img[32:66], inv, float("nan"), H, W, row0=32, rows=32, src_row0=32,
                  src_h=H)


def test_project_replicated_frame(mesh, rng):
    """A frame whose rows do not divide the mesh is warped whole and stays
    replicated."""
    from nightlight_tpu_torch.ops import resample as trs

    img = _sky(rng)[:250]
    trans = np.array([1.0, 0.0, 1.5, 0.0, 1.0, 0.5], np.float32)
    got = trs.project(_sharded(mesh, img), [W, 250], trans, float("nan"))
    assert got.replicated
    want = trs.project(torch.from_numpy(img), [W, 250], trans, float("nan"))
    np.testing.assert_array_equal(_np(got), want.numpy())


# ---------------------------------------------------------------------------
# The operators: load, calibrate, bad pixel, match, align, stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lights16(tmp_path_factory):
    """8 BITPIX-16 lights and a dark of 256x256 (the port's fixture
    writer), in a directory of their own."""
    from nightlight_tpu_torch.fixtures import gen

    d = tmp_path_factory.mktemp("lights16")
    names = [os.path.basename(p) for p in gen(str(d), 8, H, seed=11)]
    return d, names


def _load(mesh, path, loader=False):
    """OpLoad of one file under a context with `mesh` (None: unsharded),
    directly or through the read-ahead loader."""
    from nightlight_tpu_torch.io.ingest import ReadAheadLoader
    from nightlight_tpu_torch.pipeline.context import new_context
    from nightlight_tpu_torch.pipeline.operators import OpLoad

    c = new_context(log=io.StringIO(), device="cpu")
    c.mesh = mesh
    pre = ReadAheadLoader([(0, path)], c.log, c.device, mesh=mesh) if loader else None
    try:
        f = OpLoad(id=0, file_name=path, prefetcher=pre).apply(None, c)
        c.flush_log()
        return f, c
    finally:
        if pre is not None:
            pre.close()


@pytest.mark.parametrize("loader", [False, True])
def test_load_uploads_each_shard(mesh, lights16, loader):
    """A BITPIX-16 frame read under a mesh arrives row-sharded, each
    shard's rows decoded from their own byte range, directly (read_file)
    and through the read-ahead loader: bit for bit the unsharded frame,
    with the same Loaded line, and no gather."""
    d, names = lights16
    path = str(d / names[0])
    tm.GATHERS.clear()
    fs, cs = _load(mesh, path, loader)
    fu, cu = _load(None, path, loader)
    assert isinstance(fs.data, tm.RowSharded) and len(fs.data.blocks) == 8
    assert not tm.GATHERS
    np.testing.assert_array_equal(_np(fs.data), fu.data.numpy())
    assert cs.log.getvalue() == cu.log.getvalue() and "Loaded 256x256 image" in cs.log.getvalue()


def test_load_float_frame_and_indivisible_rows(mesh, rng, tmp_path):
    """A float32 frame is decoded on the host and placed by rows; a frame of
    250 rows is replicated on the lead device."""
    from nightlight_tpu_torch.image import Image
    from nightlight_tpu_torch.io import fits as tfits

    for h, replicated in ((H, False), (250, True)):
        img = _sky(rng, h=h)
        path = str(tmp_path / f"f{h}.fits")
        tfits.write_file(Image.from_numpy(img), path)
        f, _ = _load(mesh, path)
        assert isinstance(f.data, tm.RowSharded) and f.data.replicated == replicated
        np.testing.assert_array_equal(_np(f.data), img)


def _ops_chain(mesh, path, ops):
    """Load `path` under `mesh` and apply each operator in turn; returns
    (image, log)."""
    from nightlight_tpu_torch.pipeline.context import new_context
    from nightlight_tpu_torch.pipeline.operators import OpLoad

    c = new_context(log=io.StringIO(), device="cpu")
    c.mesh = mesh
    f = OpLoad(id=0, file_name=path).apply(None, c)
    for op in ops:
        f = op.apply(f, c)
    return f, c


def test_calibrate_bad_pixel_stats_match_stay_sharded(mesh, lights16, monkeypatch):
    """calibrate (dark and flat), bad-pixel repair, the -lsEst 3 statistics
    and the histogram match of a loaded frame run on its shards: the frame
    is never gathered, and image, counts and log equal the unsharded
    chain's bit for bit and line for line."""
    from nightlight_tpu_torch.image import Image
    from nightlight_tpu_torch.io import fits as tfits
    from nightlight_tpu_torch.ops.stats import Stats
    from nightlight_tpu_torch.pipeline import ops_post, ops_pre

    d, names = lights16
    monkeypatch.chdir(d)
    flat = np.random.default_rng(5).uniform(0.8, 1.0, size=(H, W)).astype(np.float32)
    tfits.write_file(Image.from_numpy(flat), "flat.fits")
    ref = Stats(torch.from_numpy(np.full((4, 4), 1000.0, np.float32)), 4)
    ref._location, ref._scale, ref._have_locscale = 1000.0, 20.0, True

    def chain(mesh):
        ctx = {}

        def matched(f, c):
            c.match_histo = ref
            _ = f.stats.location
            return ops_post.OpMatchHistogram(mode=2).apply(f, c)

        ops = [ops_pre.OpCalibrate(dark="dark.fits", flat="flat.fits"),
               ops_pre.OpBadPixel(sigma_low=3.0, sigma_high=5.0),
               ops_pre.OpScaleOffset(scale=1.5, offset=0.25)]
        f, c = _ops_chain(mesh, names[1], ops)
        f = matched(f, c)
        c.flush_log()
        ctx["log"] = c.log.getvalue()
        return f, ctx

    tm.GATHERS.clear()
    fs, ls = chain(mesh)
    assert not tm.GATHERS, dict(tm.GATHERS)
    assert isinstance(fs.data, tm.RowSharded) and len(fs.data.blocks) == 8
    fu, lu = chain(None)
    np.testing.assert_array_equal(_np(fs.data), fu.data.numpy())
    assert ls["log"] == lu["log"] and "Removed " in ls["log"]
    assert "after matching reference histogram" in ls["log"]
    assert fs.median_diff_stats.stddev == fu.median_diff_stats.stddev


# ---------------------------------------------------------------------------
# Whole jobs: the stack preset under a mesh
# ---------------------------------------------------------------------------


_FUSED_OFF = re.compile(r"^Fused batch executor off \(.*\); using the per-frame operator path\.$")


def _port_stack(d, out, flags, mesh):
    """The port's `stack` preset through run_op on the CPU, with c.mesh =
    mesh, or unsharded (None) on the per-frame path that a mesh takes: the
    fused executor found ineligible for a batch, as under a mesh, after the
    same loads and batch plan. Returns the log with the output's name and
    the fused-off line's reason blanked."""
    from nightlight_tpu_torch import cli as tcli
    from nightlight_tpu_torch.models import fastpath
    from nightlight_tpu_torch.ops.stats import LSEstimatorMode
    from nightlight_tpu_torch.pipeline.context import new_context

    args = tcli.build_parser().parse_args(["-out", out, "-jpg", "", "-log", "", *flags,
                                           "stack", "light*.fits"])
    tcli.apply_command_defaults(args)
    log = io.StringIO()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        c = new_context(log=log, device="cpu", ls_mode=LSEstimatorMode(args.lsEst))
        c.mesh = mesh
        with contextlib.redirect_stdout(io.StringIO()), fastpath.per_frame_path(mesh is None):
            tcli.run_op(tcli.build_command_seq(args), c)
    finally:
        os.chdir(cwd)
    lines = ["Fused batch executor off" if _FUSED_OFF.match(ln) else ln
             for ln in log.getvalue().replace(out, "OUT").splitlines()]
    return "\n".join(lines)


_JOB_STEPS = [
    {"type": "loadMany", "filePatterns": ["light*.fits"]},
    {"type": "calibrate", "dark": "dark.fits", "flat": ""},
    {"type": "badPixel", "sigmaLow": 3.0, "sigmaHigh": 5.0},
    {"type": "starDetect", "radius": 16, "sigma": 15.0, "badPixelSigma": 5.0,
     "inOutRatio": 1.4},
    {"type": "selectRef", "target": 1, "mode": "%starsHFR"},
    {"type": "selectRef", "target": 0, "mode": "%starsHFR"},
    {"type": "matchHist", "mode": 2},
    {"type": "align", "k": 50, "threshold": 1.0, "oobMode": 0},
    {"type": "stack", "mode": 6, "sigmaLow": -1.0, "sigmaHigh": -1.0},
]


def _run_job(d, out, mesh, jax_side=False):
    """The stack chain as a JSON job (load, calibrate with the dark, bad
    pixels, detection, references, match, align, the auto stack with the
    goal-seek, save) through either package with c.mesh = mesh. The JAX
    package's sharded CLI (`stack -shard`) is not used: on the 8 virtual
    CPU devices the sharded programs its thread pool runs at once wait on
    each other in XLA's CPU collectives until the rendezvous aborts the
    process. Its job runs one frame at a time (max_threads 1), device work
    flushed synchronously as tests/test_mesh.py does. Returns the log."""
    job = {"type": "seq", "steps": [*_JOB_STEPS, {"type": "save", "filePattern": out}]}
    log = io.StringIO()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        if jax_side:
            from nightlight_tpu.pipeline import materialize_all, op_from_dict
            from nightlight_tpu.pipeline.context import new_context

            os.environ["NIGHTLIGHT_SYNC_FLUSH"] = "1"
            c = new_context(log=log)
            c.mesh = mesh
            c.max_threads = 1  # one program at a time: see the docstring
            _, err = materialize_all(op_from_dict(job).make_promises([], c), c.max_threads,
                                     True)
        else:
            from nightlight_tpu_torch.pipeline import materialize_all, op_from_dict
            from nightlight_tpu_torch.pipeline.context import new_context

            c = new_context(log=log, device="cpu")
            c.mesh = mesh
            _, err = materialize_all(op_from_dict(job).make_promises([], c), forget=True)
        if err is not None:
            raise err
        c.finalize()
    finally:
        os.chdir(cwd)
        os.environ.pop("NIGHTLIGHT_SYNC_FLUSH", None)
    return log.getvalue()


def _counts(log):
    """Star, bad-pixel and clip counts and the frames stacked, from a log."""
    stars = sorted(re.findall(r"^(\d+): Stars (\d+) ", log, re.M))
    bad = sorted(re.findall(r"^(\d+): Removed (\d+) bad", log, re.M))
    stacked = re.findall(r"Stacking (\d+) frames", log)
    clipped = re.findall(r"Clipped low (\d+) \([\d.]+%\) high (\d+)", log)
    return stars, bad, stacked, clipped


def _without_mesh_plan(log: str) -> str:
    """The log with the batch planner's account of the mesh it counted
    taken out of its "this fits" line, the one line where a sharded run's
    log differs from the unsharded run's; asserts the account is there."""
    out, n = re.subn(r" on the mesh's \d+ devices \(\d+ MiB a frame's shard, the least "
                     r"device \d+ MiB\)", "", log)
    assert n >= 1, "the planner's line does not name the mesh"
    return out


@pytest.mark.parametrize("flags", [
    pytest.param(("-dark", "dark.fits"), id="defaults-dark"),
    pytest.param(("-dark", "dark.fits", "-lsEst", "1", "-stMode", "2", "-stSigLow", "2.5",
                  "-stSigHigh", "2.5"), id="lsEst1-sigma"),
    pytest.param(("-lsEst", "4", "-stMode", "4"), id="lsEst4-mad"),
])
def test_stack_job_sharded_equals_unsharded(mesh, lights16, tmp_path, flags):
    """The `stack` preset under a mesh of 8 CPU shards against the same job
    unsharded on the per-frame path: the same log line for line, each
    frame's lines and the others (the fused-off line's reason aside; the
    planner's line also names the mesh it counted), and the output bit for
    bit. Detection runs on the shards and the stacked
    image stays row-sharded: the one gather is the save's."""
    from nightlight_tpu_torch.io import fits as tfits

    d, _ = lights16
    tm.GATHERS.clear()
    log_s = _port_stack(d, str(tmp_path / "s.fits"), flags, mesh)
    gathers = dict(tm.GATHERS)
    log_u = _port_stack(d, str(tmp_path / "u.fits"), flags, None)
    assert "Stacking 8 frames" in log_s and "Error" not in log_s
    assert _without_mesh_plan(log_s) == log_u
    assert gathers == {"save": 1}, gathers
    a = tfits.read_file(str(tmp_path / "s.fits")).to_numpy()
    b = tfits.read_file(str(tmp_path / "u.fits")).to_numpy()
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def float_lights(tmp_path_factory):
    """8 float32 star fields of 256x256 drifting (3, -2) px a frame
    (tests/test_pipeline_e2e.py write_frames) and a float32 dark. The JAX
    package's grouped upload of BITPIX-16 frames stalls under its 8
    virtual CPU devices, so its sharded run reads float frames."""
    from nightlight_tpu_torch.image import Image
    from nightlight_tpu_torch.io import fits as tfits
    from tests.test_pipeline_e2e import write_frames

    d = tmp_path_factory.mktemp("float_lights")
    rng = np.random.default_rng(17)
    write_frames(d, rng, n_frames=8)
    dark = rng.normal(5.0, 0.2, size=(H, W)).astype(np.float32)
    tfits.write_file(Image.from_numpy(dark), str(d / "dark.fits"))
    return d


def test_stack_job_sharded_matches_jax_sharded(mesh, jmesh, float_lights, tmp_path):
    """The stack chain under the port's mesh against the JAX package's run
    of the same job under its 8-device mesh: equal star and bad-pixel
    counts and frames stacked, the output within test_mesh.py's band; and
    the port's sharded job equals its unsharded one line for line and bit
    for bit. The clip totals differ from JAX's by a few samples, and the
    same job run unsharded in both packages is the witness that the mesh
    adds nothing to that: JAX's sharded and unsharded runs clip the same
    samples, so the port-vs-JAX gap under the mesh is the gap without it.
    That gap comes from the transforms, whose centroid sums differ at
    ~1e-5 px between XLA and torch: a sample that close to a clip bound
    flips (here 2612 against JAX's 2610 high, the low totals equal). It is
    held to tests/test_torch_cli.py's band (max(2, 0.1%)), and the pixels
    outside test_mesh.py's band to at most the flipped samples (each flip
    moves one pixel's stack; here 2 of 65536)."""
    from nightlight_tpu_torch.io import fits as tfits

    d = float_lights
    tm.GATHERS.clear()
    log_t = _run_job(d, str(tmp_path / "t.fits"), mesh)
    assert dict(tm.GATHERS) == {"save": 1}, dict(tm.GATHERS)
    log_u = _run_job(d, str(tmp_path / "u.fits"), None)
    log_j = _run_job(d, str(tmp_path / "j.fits"), jmesh, jax_side=True)
    log_ju = _run_job(d, str(tmp_path / "ju.fits"), None, jax_side=True)
    assert "Stacking 8 frames" in log_t
    assert log_t.replace("t.fits", "X") == log_u.replace("u.fits", "X")
    stars, bad, stacked, clipped = _counts(log_t)
    assert (stars, bad, stacked) == _counts(log_j)[:3] == _counts(log_ju)[:3]
    assert len(stars) == 8
    # the witness: the mesh changes no count on either side
    assert _counts(log_j)[3] == _counts(log_ju)[3] and clipped == _counts(log_u)[3]
    gap = [int(ct) - int(cj) for ct, cj in zip(clipped[0], _counts(log_j)[3][0])]
    assert gap == [int(ct) - int(cj) for ct, cj in zip(_counts(log_u)[3][0],
                                                      _counts(log_ju)[3][0])]
    for g, cj in zip(gap, _counts(log_j)[3][0]):
        assert abs(g) <= max(2, 0.001 * int(cj)), (clipped, _counts(log_j)[3])
    a, u, j, ju = (tfits.read_file(str(tmp_path / n)).to_numpy()
                   for n in ("t.fits", "u.fits", "j.fits", "ju.fits"))
    np.testing.assert_array_equal(a, u)
    flips = sum(abs(g) for g in gap)
    for ref in (j, ju):
        m = np.isfinite(a) & np.isfinite(ref)
        assert m.mean() > 0.9
        off = ~np.isclose(a[m], ref[m], rtol=1e-4, atol=1e-3)
        assert off.sum() <= flips, (off.sum(), flips)


@pytest.fixture(scope="module")
def osc_lights(tmp_path_factory):
    """8 RGGB mosaics and a dark of 256x256 (the port's fixture writer)."""
    from nightlight_tpu_torch.fixtures import gen

    d = tmp_path_factory.mktemp("osc")
    gen(str(d), 8, H, seed=13, bayer="RGGB")
    return d


@pytest.mark.parametrize("flags", [
    pytest.param(("-debayer", "G", "-cfa", "RGGB", "-stMode", "2"), id="debayer-G"),
    pytest.param(("-debayer", "G", "-cfa", "RGGB", "-debandH", "50", "-debandV", "50",
                  "-preScale", "1.5", "-binning", "2", "-stMode", "2"), id="osc-chain"),
])
def test_osc_chain_sharded_equals_unsharded(mesh, osc_lights, tmp_path, flags):
    """The one-shot-colour chain under a mesh: the CFA correction and the
    debayer per shard, the debands on the gathered frame placed back, then
    scaleOffset and 2x2 binning per shard: the log line for line and the
    output bit for bit the unsharded per-frame run's (the planner's line
    also names the mesh it counted). A frame whose
    transform reaches beyond a shard's rows warps from its gathered
    source."""
    from nightlight_tpu_torch.io import fits as tfits

    flags = ("-dark", "dark.fits", *flags)
    tm.GATHERS.clear()
    log_s = _port_stack(osc_lights, str(tmp_path / "s.fits"), flags, mesh)
    gathers = dict(tm.GATHERS)
    log_u = _port_stack(osc_lights, str(tmp_path / "u.fits"), flags, None)
    assert "Debayered channel G" in log_s and "Error" not in log_s
    assert _without_mesh_plan(log_s) == log_u
    # one frame's transform reaches beyond a shard's 32 rows (its warp
    # gathers the source)
    allowed = {"save", "warp"} | ({"debandHoriz", "debandVert"}
                                  if "-debandH" in flags else set())
    assert set(gathers) <= allowed and gathers["save"] == 1, gathers
    a = tfits.read_file(str(tmp_path / "s.fits")).to_numpy()
    b = tfits.read_file(str(tmp_path / "u.fits")).to_numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("command,channels", [("rgb", "rgbl"), ("stretch", "l")])
def test_other_commands_under_mesh(mesh, tmp_path, monkeypatch, command, channels):
    """`rgb` and `stretch` under a mesh: the channels load row-sharded and
    detection runs on the shards; the colour combination, which has no
    sharded form, takes the frames whole (counted under its type), while
    the stretch (normalize, the auto-stretch, midtones, gamma, black
    scaling, detection) runs on the shards and only the save gathers; log
    and output equal the unsharded run's."""
    from nightlight_tpu_torch import cli as tcli
    from nightlight_tpu_torch.fixtures import gen_channels
    from nightlight_tpu_torch.io import fits as tfits
    from nightlight_tpu_torch.pipeline.context import new_context

    gen_channels(str(tmp_path), H, seed=7)
    monkeypatch.chdir(tmp_path)
    files = [f"chan_{ch}.fits" for ch in channels]

    def run(out, m):
        args = tcli.build_parser().parse_args(["-out", out, "-jpg", "", "-log", "", command,
                                               *files])
        tcli.apply_command_defaults(args)
        log = io.StringIO()
        c = new_context(log=log, device="cpu")
        c.mesh = m
        with contextlib.redirect_stdout(io.StringIO()):
            tcli.run_op(tcli.build_command_seq(args), c)
        return log.getvalue().replace(out, "OUT")

    tm.GATHERS.clear()
    log_s = run("s.fits", mesh)
    gathers = dict(tm.GATHERS)
    assert run("u.fits", None) == log_s
    want = {"rgbCombine": 4} if command == "rgb" else {"save": 1}
    assert gathers == want
    np.testing.assert_array_equal(tfits.read_file("s.fits").to_numpy(),
                                  tfits.read_file("u.fits").to_numpy())


def test_stretch_chain_under_mesh(mesh, tmp_path, monkeypatch):
    """`stretch` with every per-pixel stretch operator taking effect (the
    auto-stretch's gamma rounds, midtones, gamma, black scaling) under a
    mesh: each runs on the shards, the only gather is the save's, and the
    log and the output equal the unsharded run's."""
    from nightlight_tpu_torch import cli as tcli
    from nightlight_tpu_torch.fixtures import gen_channels
    from nightlight_tpu_torch.io import fits as tfits
    from nightlight_tpu_torch.pipeline.context import new_context

    gen_channels(str(tmp_path), H, seed=7)
    monkeypatch.chdir(tmp_path)
    flags = ["-autoScale", "2", "-midtone", "20", "-gamma", "1.2", "-scaleBlack", "8"]

    def run(out, m):
        args = tcli.build_parser().parse_args(["-out", out, "-jpg", "", "-log", "", *flags,
                                               "stretch", "chan_l.fits"])
        tcli.apply_command_defaults(args)
        log = io.StringIO()
        c = new_context(log=log, device="cpu")
        c.mesh = m
        with contextlib.redirect_stdout(io.StringIO()):
            tcli.run_op(tcli.build_command_seq(args), c)
        return log.getvalue().replace(out, "OUT")

    tm.GATHERS.clear()
    log_s = run("s.fits", mesh)
    gathers = dict(tm.GATHERS)
    assert run("u.fits", None) == log_s
    assert gathers == {"save": 1}, gathers
    for text in ("applying gamma", "Applying midtone correction", "Applying gamma 1.2",
                 "scaling black to move location to 8.00%"):
        assert text in log_s, text
    np.testing.assert_array_equal(tfits.read_file("s.fits").to_numpy(),
                                  tfits.read_file("u.fits").to_numpy())
