"""Phases 3-6 of star detection on the CPU: kernel K8's host mirror
(csrc/detect_finish_host.cpp over csrc/detect_finish.cuh, compiled with
g++) held against the plain version detect/stars.py _finish, the
specification the card is held to, and against the JAX package's
find_stars on the same images; the mirror bit for bit the same for a
frame alone, inside a chunk of 8 and fed as the sharded path feeds it; the
chunk's phase 2 against the per-frame one; and the dispatch of _Finish,
which sends a CPU tensor to the plain version and nothing else there."""

import inspect
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightlight_tpu.detect import stars as jstars
from nightlight_tpu_torch import kernels
from nightlight_tpu_torch.detect import stars
from nightlight_tpu_torch.ops.gather_cuda import gather_patches, patches_plain
from nightlight_tpu_torch.ops.prestack import median9

torch.set_num_threads(1)

CSRC = Path(stars.__file__).resolve().parent.parent / "csrc"


def synth_field(rng, h=256, w=256, stars_at=(), bg=100.0, noise=2.0, fwhm=8.0, flux=8000.0):
    img = rng.normal(bg, noise, size=(h, w)).astype(np.float32)
    sigma = fwhm / 2.3548
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for sx, sy in stars_at:
        img += flux / (2 * np.pi * sigma ** 2) * np.exp(
            -((xx - sx) ** 2 + (yy - sy) ** 2) / (2 * sigma ** 2))
    return img


def _field(name):
    """(image, (location, scale, star_sig, bp_sig, star_in_out, radius,
    median_diff_std)) of the fields of tests/test_torch_stars.py, a dense
    field of over 1,000 phase-2 survivors, a field with NaN and +-inf
    pixels in and beside the stars, and a field where a hot pixel beside
    each star converges onto it."""
    if name == "field":
        pos = [(40.3, 50.7), (120.0, 80.2), (200.6, 200.1), (60.0, 180.5), (10.2, 128.0),
               (250.0, 5.0), (130.0, 132.0), (137.0, 139.0)]
        return synth_field(np.random.default_rng(7), stars_at=pos), (
            100.0, 2.0, 15.0, 5.0, 1.4, 16, 2.5)
    if name.startswith("random"):
        rng = np.random.default_rng(int(name[6]))
        pos = [tuple(rng.uniform(8, 248, 2)) for _ in range(25)]
        img = synth_field(rng, stars_at=pos, flux=rng.uniform(3000, 20000))
        if name.endswith("r8"):
            return img, (100.0, 2.0, 10.0, 0.0, 1.4, 8, 0.0)
        img[rng.integers(0, 256, 20), rng.integers(0, 256, 20)] += 800.0  # hot pixels
        return img, (100.0, 2.0, 15.0, 5.0, 1.4, 16, 2.1)
    rng = np.random.default_rng(11)
    if name == "converge":
        # a hot pixel 6 px down and right of each star: farther than the
        # radius, so both candidates pass the first filter, but inside the
        # star's window, so both converge onto the same centroid with masses
        # equal to rounding (no bad-pixel test, bp_sig 0); which of the two
        # survives the second filter follows the last bit of those sums
        pos = [(24.0 + 30.0 * (i % 7) + rng.uniform(-1, 1), 24.0 + 30.0 * (i // 7)
                + rng.uniform(-1, 1)) for i in range(49)]
        img = synth_field(rng, stars_at=pos, fwhm=6.0, flux=20000.0)
        for sx, sy in pos:
            img[int(round(sy)) + 6, int(round(sx)) + 6] += 800.0
        return img, (100.0, 2.0, 10.0, 0.0, 1.4, 8, 0.0)
    if name == "dense":
        # 1,225 stars 14 px apart (jittered), each one candidate: no two
        # candidates converge on one star, whose duplicates' masses tie
        # and make the survivor a coin toss on both sides
        grid = (np.mgrid[0:35, 0:35].reshape(2, -1).T * 14.0 + 18.0
                + rng.uniform(-2.0, 2.0, (1225, 2)))
        img = rng.normal(100, 2, (512, 512)).astype(np.float32)
        sigma = 3.0 / 2.3548
        yy, xx = np.mgrid[0:512, 0:512].astype(np.float32)
        for (sy, sx), flux in zip(grid, rng.uniform(800, 4000, 1225)):
            y0, x0 = int(sy) - 8, int(sx) - 8
            win = (slice(max(y0, 0), y0 + 17), slice(max(x0, 0), x0 + 17))
            img[win] += flux / (2 * np.pi * sigma ** 2) * np.exp(
                -((xx[win] - sx) ** 2 + (yy[win] - sy) ** 2) / (2 * sigma ** 2))
        return img, (100.0, 2.0, 10.0, 0.0, 1.2, 4, 0.0)
    pos = [tuple(rng.uniform(8, 248, 2)) for _ in range(30)]
    img = synth_field(rng, stars_at=pos, flux=12000.0)
    for k, (sx, sy) in enumerate(pos[:12]):
        img[int(sy) + k % 5 - 2, int(sx) + k % 7 - 3] = (np.nan, np.inf, -np.inf)[k % 3]
    return img, (100.0, 2.0, 10.0, 0.0, 1.4, 8, 0.0)


FIELDS = ["field", "random1_r8", "random1_r16", "random2_r8", "random2_r16", "dense", "holes",
          "converge"]


def _candidates(imgs, args, cap):
    """Phases 1-2 of find_stars_batch and K4's plain version on a (B, H, W)
    chunk: per frame (cy, cx, vals, keep, patch, ok)."""
    loc, scale, sig, bp_sig, _, radius, mds = args
    b, _, w = imgs.shape
    t = torch.from_numpy(imgs)
    lo, sc, md = (torch.full((b,), v, dtype=torch.float32) for v in (loc, scale, mds))
    cv = stars._candidate_values(t, lo + sc * stars._host_f32(sig))
    vals, idx = stars._select_brightest(cv, cap)
    vals = vals.contiguous()
    cy = torch.div(idx, w, rounding_mode="floor").to(torch.int32)
    cx = (idx % w).to(torch.int32)
    keep = (vals > -np.inf) & stars._bad_pixel_ok(t, cy, cx, vals, bp_sig,
                                                  (md * stars._host_f32(bp_sig))[:, None])
    return [(cy[i], cx[i], vals[i], keep[i], *gather_patches(t[i], cy[i], cx[i], 2 * radius))
            for i in range(b)]


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build csrc/detect_finish_host.cpp")
    d = tmp_path_factory.mktemp("detect_finish")
    exe = d / "mirror"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
                    "-I", str(CSRC), str(CSRC / "detect_finish_host.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=600)

    def run(frame, args):
        """The mirror's output row of one frame; keep None feeds it as the
        sharded path does (every candidate a survivor)."""
        loc, scale, sig, _, in_out, radius, _ = args
        cy, cx, vals, keep, patch, ok = frame
        k = int(cy.shape[0])
        src, dst = d / "in.bin", d / "out.bin"
        with open(src, "wb") as f:
            f.write(np.array([k, radius, k, keep is not None], np.int32).tobytes())
            f.write(np.array([loc, scale, sig, in_out, stars._disk_limit(radius)],
                             np.float32).tobytes())
            for a, dtype in ((cy, np.int32), (cx, np.int32), (vals, np.float32),
                             (keep, np.uint8), (patch, np.float32), (ok, np.uint8)):
                if a is not None:
                    f.write(np.ascontiguousarray(a.numpy(), dtype).tobytes())
        subprocess.run([str(exe), str(src), str(dst)], check=True, timeout=300)
        return np.fromfile(dst, np.float32)

    return run


def _stars_of(row):
    """(StarList, avg HFR, survivors) of a K8 output row."""
    num = int(row[0])
    cap = (row.size - stars._ROW_HEAD) // stars._STAR_FIELDS
    f = row[stars._ROW_HEAD:].reshape(stars._STAR_FIELDS, cap)[:, :num]
    return stars.StarList(*f, count=num), float(row[1]), int(row[2])


def _compacted(frame):
    """A frame's phase-2 survivors alone, in candidate order, as
    find_stars_sharded hands them to the finish (no mask)."""
    cy, cx, vals, keep, patch, ok = frame
    at = torch.nonzero(keep)[:, 0]
    return cy[at], cx[at], vals[at], None, patch[at], ok[at]


def _plain(frame, args):
    loc, scale, sig, _, in_out, radius, _ = args
    finish = stars._Finish(1, int(frame[0].shape[0]), torch.device("cpu"))
    finish.frame(0, stars._host_f32(loc), stars._host_f32(scale), sig, in_out, radius, *frame)
    (got,), (hfr,) = finish.read()
    return got, hfr


def _refined(frame, args):
    """Every phase-2 survivor's value, refined x and y and HFR mass by the
    plain version's phases 4 and 6, as numpy arrays."""
    loc, scale, sig, _, _, radius, _ = args
    cy, cx, vals, _, patch, ok = _compacted(frame)
    location = stars._host_f32(loc)
    threshold = location + stars._host_f32(scale) * stars._host_f32(sig) * 0.5
    x, y, _, oy, ox, offs = stars._center_of_mass(patch, ok, cy, cx, threshold, radius)
    mass2 = stars._hfr(patch, ok, offs, oy, ox, location, radius)[1]
    return [t.numpy() for t in (vals, x, y, mass2)]


def _is_tie(got, j, refined):
    """Whether star j of `got` sits where a phase-2 survivor with its value
    converged: that candidate's refined place within 1e-3 px and its mass
    within 1e-4 relative of the star's."""
    vals, x, y, mass = refined
    at = vals.view(np.int32) == np.float32(got.value[j]).view(np.int32)
    return bool((at & (np.abs(x - got.x[j]) <= 1e-3) & (np.abs(y - got.y[j]) <= 1e-3)
                 & (np.abs(mass - got.mass[j]) <= 1e-4 * abs(got.mass[j]))).any())


def _assert_same_stars(got, got_hfr, want, want_hfr, value_rtol, refined=None):
    """Counts and order equal, positions to 1e-3 px, masses, HFRs and the
    average HFR to 1e-4 relative (tests/test_torch_stars.py's tolerances:
    the sums run in another float32 order), values to value_rtol. With
    `refined`, a star whose value differs must be a tie (_is_tie): two
    candidates converged onto it, and either may keep it."""
    assert got.count == want.count > 0
    np.testing.assert_allclose(got.x, want.x, atol=1e-3)
    np.testing.assert_allclose(got.y, want.y, atol=1e-3)
    np.testing.assert_allclose(got.mass, want.mass, rtol=1e-4)
    np.testing.assert_allclose(got.hfr, want.hfr, rtol=1e-4)
    assert got_hfr == pytest.approx(want_hfr, rel=1e-4)
    differ = ~np.isclose(got.value, want.value, rtol=value_rtol, atol=0)
    if refined is None:
        assert not differ.any()
    else:
        assert all(_is_tie(got, j, refined) for j in np.nonzero(differ)[0])


def _jax(img, args):
    loc, scale, sig, bp_sig, in_out, radius, mds = args
    return jstars.find_stars(jnp.asarray(img), loc, scale, sig, bp_sig, in_out, radius, mds,
                             use_pallas_gather=False)


@pytest.mark.parametrize("name", FIELDS)
def test_mirror_matches_the_plain_version(mirror, name):
    """The mirror against _finish and against the JAX package's find_stars
    on the same image, both within _assert_same_stars: values bit for bit
    the plain version's and to 1e-6 relative the JAX package's, except in
    the field built for ties, where a star may keep either tied
    candidate's value on each side."""
    img, args = _field(name)
    frame = _candidates(img[None], args, 2048)[0]
    survivors = int(frame[3].sum())
    got, got_hfr, got_survivors = _stars_of(mirror(frame, args))
    assert got_survivors == survivors
    refined = _refined(frame, args) if name == "converge" else None
    _assert_same_stars(got, got_hfr, *_plain(frame, args), 0.0, refined)
    _assert_same_stars(got, got_hfr, *_jax(img, args), 1e-6, refined)
    if name == "dense":
        assert survivors >= 1000
    if name == "holes":  # a NaN or an infinity inside some star's window
        assert not np.isfinite(img).all()
    if name == "converge":  # pairs that pass the first filter and converge
        cy, cx, vals, _, _, _ = _compacted(frame)
        alive = stars._overlap_filter(cx.to(torch.float32), cy.to(torch.float32), vals,
                                      torch.ones(survivors, dtype=torch.bool),
                                      torch.arange(survivors, dtype=torch.float32),
                                      float(args[5])).numpy()
        _, x, y, _ = refined
        x, y = x[alive], y[alive]
        close = np.hypot(x[:, None] - x[None, :], y[:, None] - y[None, :]) < 1e-2
        assert (close.sum() - close.shape[0]) // 2 >= 10


def test_mirror_is_the_same_alone_in_a_chunk_and_sharded(mirror):
    """A frame's row, bit for bit: the frame alone, the same frame inside a
    chunk of 8 (phases 1-2 run on the chunk), and its survivors compacted
    with no mask, as find_stars_sharded feeds them."""
    rng = np.random.default_rng(5)
    _, args = _field("random1_r16")
    chunk = np.stack([synth_field(rng, stars_at=[tuple(rng.uniform(8, 248, 2))
                                                 for _ in range(25)]) for _ in range(8)])
    chunk[3, rng.integers(0, 256, 20), rng.integers(0, 256, 20)] += 800.0
    alone = _candidates(chunk[3:4], args, 512)[0]
    inside = _candidates(chunk, args, 512)[3]
    for a, b in zip(alone, inside):
        assert torch.equal(a, b)
    row = mirror(alone, args)
    assert np.array_equal(row.view(np.int32), mirror(inside, args).view(np.int32))
    survivors = int(alone[3].sum())
    sharded = mirror(_compacted(alone), args)
    head = stars._ROW_HEAD
    assert np.array_equal(row[:head].view(np.int32), sharded[:head].view(np.int32))
    num = int(row[0])
    fields = row[head:].reshape(stars._STAR_FIELDS, -1)[:, :num]
    fields_s = sharded[head:].reshape(stars._STAR_FIELDS, survivors)[:, :num]
    assert num > 5 and np.array_equal(fields.view(np.int32), fields_s.view(np.int32))


@pytest.mark.parametrize("shape", [(), (3,)])
def test_chunk_phase_two_is_the_per_frame_one(shape):
    """The chunk's bad-pixel test, a gather of the clamped 3x3 neighbours,
    against the per-frame form it replaced (K4's plain version at radius 1,
    the taps in row order), bit for bit, with candidates on every edge."""
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.normal(100, 5, size=(*shape, 40, 56)).astype(np.float32))
    k = 30

    def centres(edge, corners):
        inner = rng.integers(0, edge, (*shape, k - 4))
        return torch.from_numpy(np.concatenate(
            [inner, np.broadcast_to(corners, (*shape, 4))], axis=-1).astype(np.int32))

    cy, cx = centres(40, [0, 39, 5, 0]), centres(56, [0, 55, 55, 20])
    vals = torch.from_numpy(rng.normal(110, 8, size=(*shape, k)).astype(np.float32))
    thr = torch.tensor(6.0)
    got = stars._bad_pixel_ok(imgs, cy, cx, vals, 5.0, thr)
    frames = [(imgs, cy, cx, vals)] if not shape else list(zip(imgs, cy, cx, vals))
    want = []
    for img, y, x, v in frames:
        p9, _ = patches_plain(img, y, x, 1)
        med = median9([p9[:, j // 3, j % 3] for j in range(9)])
        want.append((v - med).abs() < thr)
    assert torch.equal(got, torch.stack(want) if shape else want[0])
    assert 0 < int(got.sum()) < got.numel()
    assert bool(stars._bad_pixel_ok(imgs, cy, cx, vals, 0.0, thr).all())


def test_find_stars_batch_equals_find_stars_frame_by_frame():
    """A chunk of three frames, phases 1-2 on the chunk, gives each frame's
    find_stars result bit for bit, the per-frame values taken as host
    numbers and as tensors."""
    rng = np.random.default_rng(9)
    imgs = np.stack([synth_field(rng, stars_at=[tuple(rng.uniform(8, 248, 2))
                                                for _ in range(20)]) for _ in range(3)])
    locs, scales, mds = [100.0, 100.5, 99.5], [2.0, 2.1, 1.9], [2.5, 2.4, 2.6]
    for as_tensor in (False, True):
        cols = [torch.tensor(c) if as_tensor else c for c in (locs, scales, mds)]
        got, hfrs = stars.find_stars_batch(torch.from_numpy(imgs), cols[0], cols[1], 15.0, 5.0,
                                           1.4, 16, cols[2])
        for i in range(3):
            want, hfr = stars.find_stars(torch.from_numpy(imgs[i]), locs[i], scales[i], 15.0, 5.0,
                                         1.4, 16, mds[i])
            assert got[i].count == want.count > 3 and hfrs[i] == hfr
            for f in ("x", "y", "value", "mass", "hfr"):
                assert np.array_equal(getattr(got[i], f), getattr(want, f))


def test_cuda_tensor_never_reaches_plain_version():
    """_Finish sends a CPU frame to the plain _finish and counts no K8
    launch; anything else goes to the kernel's wrapper, which refuses what
    is not a CUDA tensor, with no fallback."""
    src = inspect.getsource(stars._Finish)
    assert src.count("_finish(") == 1 and src.count("_finish_cuda(") == 1
    launch, plain = src.index("_finish_cuda("), src.index("_finish(")
    assert src.index("if self.rows is not None:") < launch < src.index("return", launch) < plain
    assert "try:" not in src and "try:" not in inspect.getsource(stars._finish_cuda)
    kernels.reset_launch_counts()
    img, args = _field("field")
    frame = _candidates(img[None], args, 256)[0]
    got, _ = _plain(frame, args)
    assert got.count > 0 and kernels.launch_counts()["detect_finish"] == 0
    row = torch.zeros(stars._ROW_HEAD + stars._STAR_FIELDS * 256)
    with pytest.raises(ValueError, match="CUDA"):
        stars._finish_cuda(row, 256, torch.tensor(100.0), torch.tensor(2.0), 15.0, 1.4, 16,
                           *frame)


@pytest.mark.parametrize("radius", [1, 8, 16])
def test_offset_step_is_the_jax_packages_int32_step(radius):
    """The centre of mass's window step, o + round(d) clamped to +-radius,
    against the JAX package's int32 form bit for bit, where XLA converts a
    NaN shift to 0, saturates one beyond int32 and wraps the sum: the
    shifts a NaN or infinite pixel in a window gives."""
    big = [np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 - 128]
    d = np.array(big + [0.5, 1.5, -0.5, -2.5, 7.49, -7.51, 0.0, 40.0], np.float32)
    o = np.arange(-radius, radius + 1, dtype=np.int32)
    o, d = (a.ravel() for a in np.meshgrid(o, d))
    want = np.clip(o + jnp.round(jnp.asarray(d)).astype(jnp.int32), -radius, radius)
    got = stars._offset_step(torch.from_numpy(o.astype(np.int64)), torch.from_numpy(d), radius)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
