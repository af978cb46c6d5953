"""FITS I/O, JPEG/TIFF export and pre-stack repair of the port, held
against the JAX package on the CPU."""

import gzip
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightlight_tpu.image import Image as JImage
from nightlight_tpu.io import fits as jfits
from nightlight_tpu.ops import prestack as jps
from nightlight_tpu_torch.image import Image as TImage
from nightlight_tpu_torch.io import fits as tfits
from nightlight_tpu_torch.ops import prestack as tps

torch.set_num_threads(1)


def _fits_bytes(bitpix: int, data: np.ndarray, bzero=None, bscale=None, extra=()):
    h, w = data.shape
    lines = [f"{'SIMPLE':<8}= {'T':>20} / {'':47}",
             f"{'BITPIX':<8}= {bitpix:>20} / {'':47}",
             f"{'NAXIS':<8}= {'2':>20} / {'':47}",
             f"{'NAXIS1':<8}= {w:>20} / {'':47}",
             f"{'NAXIS2':<8}= {h:>20} / {'':47}"]
    if bzero is not None:
        lines.append(f"{'BZERO':<8}= {bzero:>20} / {'':47}")
    if bscale is not None:
        lines.append(f"{'BSCALE':<8}= {bscale:>20} / {'':47}")
    lines += [f"{k:<8}= {v:>20} / {'':47}" for k, v in extra]
    lines.append("HISTORY made by a test" + " " * 58)
    lines.append("END" + " " * 77)
    header = "".join(lines)
    header += " " * (-len(header) % 2880)
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    payload = data.astype(dt).tobytes()
    return header.encode("ascii") + payload + b"\0" * (-len(payload) % 2880)


@pytest.mark.parametrize("bitpix,bzero,bscale", [
    (8, None, None), (16, "32768", "1"), (16, None, "0.5"), (32, "10.", "2."),
    (-32, None, None), (-64, "1.5", None)])
@pytest.mark.parametrize("gz", [False, True])
def test_fits_read_equal(tmp_path, bitpix, bzero, bscale, gz):
    """Decoded pixels, dimensions, exposure and header dictionaries equal the
    JAX reader's; BITPIX 8/16 decode on the device in the port."""
    rng = np.random.default_rng(abs(bitpix))
    lo, hi = {8: (0, 255), 16: (-32768, 32767), 32: (-100000, 100000)}.get(bitpix, (-1e3, 1e3))
    data = rng.uniform(lo, hi, size=(37, 53))
    if bitpix > 0:
        data = np.round(data)
    raw = _fits_bytes(bitpix, data, bzero, bscale, extra=[("EXPTIME", "30.5"),
                                                          ("OBJECT", "'M 42'")])
    name = tmp_path / ("f.fits.gz" if gz else "f.fits")
    name.write_bytes(gzip.compress(raw) if gz else raw)
    sink = io.StringIO()
    j = jfits.read_file(str(name), log=sink)
    t = tfits.read_file(str(name), log=io.StringIO())
    assert t.naxisn == j.naxisn and t.exposure == j.exposure == 30.5
    assert t.header.strings == j.header.strings and t.header.history == j.header.history
    np.testing.assert_array_equal(t.to_numpy(), np.asarray(j.data))
    assert t.stats.min == pytest.approx(float(j.stats.min))
    assert t.stats.max == pytest.approx(float(j.stats.max))


def test_fits_write_byte_identical(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.normal(100, 3, size=(41, 29)).astype(np.float32)
    data[3, 4] = np.nan
    data[5, 6] = np.inf
    j = JImage.from_naxisn([29, 41], jnp.asarray(data))
    t = TImage.from_numpy(data)
    for img in (j, t):
        img.exposure = 120.0
        img.header.strings["OBJECT"] = "a rather long object name for CONTINUE cards"
        img.header.ints["GAIN"] = 139
        img.header.floats["CCD-TEMP"] = -10.5
    jfits.write_file(j, str(tmp_path / "j.fits"))
    tfits.write_file(t, str(tmp_path / "t.fits"))
    assert (tmp_path / "j.fits").read_bytes() == (tmp_path / "t.fits").read_bytes()
    back = tfits.read_file(str(tmp_path / "t.fits"))
    assert back.header.ints["GAIN"] == 139


def test_jpeg_and_tiff_export_match(tmp_path):
    from nightlight_tpu.io import jpeg as jjpeg, tiff as jtiff
    from nightlight_tpu_torch.io import jpeg as tjpeg, tiff as ttiff
    from PIL import Image as PILImage

    rng = np.random.default_rng(2)
    data = rng.uniform(0, 60000, size=(33, 47)).astype(np.float32)
    data[0, 0] = np.nan
    j = JImage.from_naxisn([47, 33], jnp.asarray(data))
    t = TImage.from_numpy(data)
    jjpeg.write_mono_jpg(j, str(tmp_path / "j.jpg"), 0.0, 65535.0, 1.0)
    tjpeg.write_mono_jpg(t, str(tmp_path / "t.jpg"), 0.0, 65535.0, 1.0)
    assert (tmp_path / "j.jpg").read_bytes() == (tmp_path / "t.jpg").read_bytes()
    jtiff.write_mono_tiff16(j, str(tmp_path / "j.tif"), 10.0, 50000.0, 2.2)
    ttiff.write_mono_tiff16(t, str(tmp_path / "t.tif"), 10.0, 50000.0, 2.2)
    a = np.asarray(PILImage.open(tmp_path / "j.tif")).astype(np.int64)
    b = np.asarray(PILImage.open(tmp_path / "t.tif")).astype(np.int64)
    # gamma: pow in float32 on two libraries may round one level apart
    assert np.abs(a - b).max() <= 1


def _frame(rng, h=96, w=128):
    x = rng.normal(1000.0, 15.0, size=(h, w)).astype(np.float32)
    hot = rng.uniform(size=(h, w)) < 0.004
    x[hot] += rng.uniform(300, 3000, size=hot.sum())
    cold = rng.uniform(size=(h, w)) < 0.002
    x[cold] -= 400.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bad_pixel_repair_counts_exact(seed):
    rng = np.random.default_rng(seed)
    x = _frame(rng)
    jr, jn, js = jps.bad_pixel_repair(jnp.asarray(x), 3.0, 5.0)
    tr, tn, ts = tps.bad_pixel_repair(torch.from_numpy(x), 3.0, 5.0)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    # stddev: float64 accumulation here, float32 in XLA
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)


def test_bad_pixel_repair_batch_equals_per_frame():
    rng = np.random.default_rng(4)
    xs = np.stack([_frame(rng) for _ in range(3)])
    tr, tn, ts = tps.bad_pixel_repair(torch.from_numpy(xs), 3.0, 5.0)
    for i in range(3):
        r1, n1, s1 = tps.bad_pixel_repair(torch.from_numpy(xs[i]), 3.0, 5.0)
        assert int(n1) == int(tn[i]) and float(s1) == float(ts[i])
        assert torch.equal(r1, tr[i])


def test_median_filter_and_calibration():
    rng = np.random.default_rng(6)
    x = _frame(rng)
    dark = rng.normal(100, 3, size=x.shape).astype(np.float32)
    flat = rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
    flat[0, :5] = 0.0  # degenerate flat pixels pass through
    np.testing.assert_array_equal(tps.median_filter_3x3(torch.from_numpy(x)).numpy(),
                                  np.asarray(jps.median_filter_3x3(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tps.subtract(torch.from_numpy(x), torch.from_numpy(dark)).numpy(),
        np.asarray(jps.subtract(jnp.asarray(x), jnp.asarray(dark))))
    np.testing.assert_allclose(
        tps.flat_divide(torch.from_numpy(x), torch.from_numpy(flat), 1.4).numpy(),
        np.asarray(jps.flat_divide(jnp.asarray(x), jnp.asarray(flat), 1.4)), rtol=1e-6)


def test_fixtures_match_gen_fixtures_script(tmp_path):
    """The port's jax-free fixture writer gives the same bytes as
    scripts/gen_fixtures.py for the same seed (dark and every light)."""
    import importlib.util
    import os

    from nightlight_tpu_torch import fixtures

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "gen_fixtures.py")
    spec = importlib.util.spec_from_file_location("gen_fixtures", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.gen(str(tmp_path / "s"), 3, 192, seed=5)
    fixtures.gen(str(tmp_path / "t"), 3, 192, seed=5)
    names = sorted(os.listdir(tmp_path / "s"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 4
    for name in names:
        assert (tmp_path / "s" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()
