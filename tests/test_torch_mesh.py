"""The port's device mesh (nightlight_tpu_torch/parallel/mesh.py), held
against the JAX package's (nightlight_tpu/parallel/mesh.py), one test for
each of tests/test_mesh.py's, plus the sharded goal-seek with its subsample
engaged and the port's own routing checks.

The JAX side runs on the 8-device virtual CPU mesh that tests/conftest.py
forces, its Pallas kernels in interpret mode where test_mesh.py runs them
so; the port side on ``make_mesh([cpu] * 8)``: eight shards on the CPU,
each stack the kernels' plain versions. Inputs are numpy arrays from a
seed. Clip counts, sigmas and iteration counts are exact; images are bit
for bit against the port's unsharded functions and the JAX package's XLA
stack, and within test_mesh.py's atol 1e-5 against its Pallas kernels.
Tolerances are stated per test. The JAX package's sharded calibrate /
match / warp steps have no twin in the port: its -shard runs the per-frame
operators on the shards (tests/test_torch_mesh_frames.py)."""

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightlight_tpu.ops import findsigma as jfs
from nightlight_tpu.ops import stack as jstk
from nightlight_tpu.parallel import mesh as jm
from nightlight_tpu_torch.ops import findsigma as tfs
from nightlight_tpu_torch.ops import stack as tstk
from nightlight_tpu_torch.parallel import mesh as tm

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jm.make_mesh()


@pytest.fixture(scope="module")
def mesh():
    return tm.make_mesh([CPU] * 8)


@pytest.fixture
def interpret():
    from nightlight_tpu.ops import stack_pallas as sp

    old = sp.INTERPRET
    sp.INTERPRET = True
    yield
    sp.INTERPRET = old


def _mk_inputs(rng, n=10, h=64, w=48):
    frames = rng.normal(100.0, 2.0, size=(n, h, w)).astype(np.float32)
    frames[3, 10, 10] += 400.0  # outlier to exercise clipping
    return frames


def _np(x):
    return tm.gather(x).numpy()


def _same(port, jax_out):
    """Bit for bit, NaNs in the same places."""
    np.testing.assert_array_equal(_np(port), np.asarray(jax_out))


def _band(port, jax_out):
    """test_mesh.py's band, atol 1e-5, NaNs in the same places: against the
    Pallas kernels in interpret mode, whose weighted and winsorized sums
    round some products apart from XLA's fused programs (one float32 step
    of ~100 on a few pixels; tests/test_torch_stack.py's K1 band)."""
    a, b = _np(port), np.asarray(jax_out)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def _counts(out):
    return int(out[1]), int(out[2])


class TestShardedStack:
    def test_mesh_uses_all_devices(self, mesh, jmesh, monkeypatch):
        assert mesh.size == jmesh.devices.size == len(jax.devices()) == 8
        assert mesh.lead == CPU and all(d == CPU for d in mesh.devices)
        # the default mesh is every card; without one it raises
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.make_mesh()

    def test_output_is_row_sharded(self, mesh, rng):
        frames = _mk_inputs(rng, n=8)
        stacked, _, _ = tstk.stack_sharded(torch.from_numpy(frames), mesh,
                                           tstk.StackMode.Sigma)
        # one block per shard, each rows/8 on its device
        assert isinstance(stacked, tm.RowSharded) and not stacked.replicated
        assert len(stacked.blocks) == 8
        assert all(b.shape == (frames.shape[1] // 8, frames.shape[2]) for b in stacked.blocks)
        assert tuple(stacked.shape) == frames.shape[1:]

    def test_input_row_sharding_spec(self, mesh, jmesh):
        s = tm.shard_rows(mesh, torch.zeros(3, 16, 4))
        assert s.spec == tuple(jm.shard_rows(jmesh).spec) == (None, "pix", None)
        assert [tuple(b.shape) for b in s.blocks] == [(3, 2, 4)] * 8
        with pytest.raises(ValueError, match="divides"):
            tm.shard_rows(mesh, torch.zeros(3, 12, 4))


class TestShardedKernels:
    """stack_sharded runs each shard's stack on its local rows (JAX: the
    Pallas kernels shard_map'ed, in interpret mode here). The reduction is
    per pixel, so sharding changes no bit against the unsharded stack;
    against the Pallas kernels the port's plain versions hold _band's atol
    1e-5 with equal clip counts, against JAX's XLA stack bit for bit."""

    def test_sharded_kernel_matches_unsharded(self, mesh, jmesh, rng, interpret):
        frames = _mk_inputs(rng, n=10, h=64, w=128)
        frames[2, 5, 7] = np.nan  # missing-data lane
        got = tstk.stack_sharded(torch.from_numpy(frames), mesh, tstk.StackMode.Sigma,
                                 sigma_low=2.0, sigma_high=2.0)
        unsharded = tstk.stack(torch.from_numpy(frames), tstk.StackMode.Sigma,
                               sigma_low=2.0, sigma_high=2.0)
        np.testing.assert_array_equal(_np(got[0]), unsharded[0].numpy())
        assert _counts(got) == _counts(unsharded) and _counts(got)[1] >= 1
        want = jstk.stack_sharded(jax.device_put(jnp.asarray(frames), jm.shard_rows(jmesh)),
                                  jmesh, jstk.StackMode.Sigma, sigma_low=2.0, sigma_high=2.0,
                                  use_pallas=True)
        _band(got[0], want[0])
        assert _counts(got) == _counts(want)

    def test_sharded_kernel_weighted_winsor(self, mesh, jmesh, rng, interpret):
        frames = _mk_inputs(rng, n=8, h=32, w=128)
        w = np.linspace(0.5, 1.5, 8).astype(np.float32)
        got = tstk.stack_sharded(torch.from_numpy(frames), mesh, tstk.StackMode.WinsorSigma,
                                 weights=torch.from_numpy(w), sigma_low=2.0, sigma_high=2.0)
        unsharded = tstk.stack(torch.from_numpy(frames), tstk.StackMode.WinsorSigma,
                               weights=torch.from_numpy(w), sigma_low=2.0, sigma_high=2.0)
        np.testing.assert_array_equal(_np(got[0]), unsharded[0].numpy())
        assert _counts(got) == _counts(unsharded)
        twins = [jstk.stack_sharded(jax.device_put(jnp.asarray(frames), jm.shard_rows(jmesh)),
                                    jmesh, jstk.StackMode.WinsorSigma, weights=jnp.asarray(w),
                                    sigma_low=2.0, sigma_high=2.0, use_pallas=pallas)
                 for pallas in (False, True)]
        # the JAX package's XLA twin: bit for bit, equal counts
        _same(got[0], twins[0][0])
        assert _counts(got) == _counts(twins[0])
        # its Pallas kernel rounds the weighted sums apart and flips one
        # borderline sample on each side against its own XLA twin here
        _band(got[0], twins[1][0])
        assert all(abs(x - y) <= 1 for x, y in zip(_counts(twins[1]), _counts(twins[0])))

    @pytest.mark.parametrize("mode", list(range(0, 7)))
    def test_stack_sharded_every_mode(self, mesh, jmesh, rng, mode):
        """Modes 0-6 (6: auto, resolved before the split), weighted where
        the mode has weights: the port's sharded stack against JAX's (its
        XLA stack per shard), bit for bit with equal clip counts (the mean:
        within rtol 1e-6)."""
        frames = _mk_inputs(rng, n=10, h=32, w=24)
        frames[1, 3, 4] = np.nan
        w = np.linspace(0.5, 1.5, 10).astype(np.float32) if mode in (1, 2, 3) else None
        got = tstk.stack_sharded(torch.from_numpy(frames), mesh, tstk.StackMode(mode),
                                 weights=None if w is None else torch.from_numpy(w),
                                 sigma_low=2.0, sigma_high=2.0, ref_frame_loc=7.0)
        want = jstk.stack_sharded(jax.device_put(jnp.asarray(frames), jm.shard_rows(jmesh)),
                                  jmesh, jstk.StackMode(mode),
                                  weights=None if w is None else jnp.asarray(w),
                                  sigma_low=2.0, sigma_high=2.0, ref_frame_loc=7.0)
        if mode == 1:
            # the weighted mean's frame sums reduce in XLA's order:
            # tests/test_torch_stack.py's mean band, rtol 1e-6
            np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-6)
        else:
            _same(got[0], want[0])
        assert _counts(got) == _counts(want)

    def test_stack_mesh_param_routes_sharded(self, mesh, jmesh, rng, interpret):
        frames = _mk_inputs(rng, n=6, h=32, w=64)
        out, lo, hi = tstk.stack(tm.shard_rows(mesh, torch.from_numpy(frames)),
                                 tstk.StackMode.Sigma, mesh=mesh)
        # the result is row-sharded: it came back through stack_sharded
        assert isinstance(out, tm.RowSharded) and len(out.blocks) == 8
        u_out, u_lo, u_hi = tstk.stack(torch.from_numpy(frames), tstk.StackMode.Sigma)
        np.testing.assert_array_equal(_np(out), u_out.numpy())
        assert (int(lo), int(hi)) == (int(u_lo), int(u_hi))
        j_out, j_lo, j_hi = jstk.stack(
            jax.device_put(jnp.asarray(frames), jm.shard_rows(jmesh)), jstk.StackMode.Sigma,
            mesh=jmesh, use_pallas=True)
        _band(out, j_out)
        assert (int(lo), int(hi)) == (int(j_lo), int(j_hi))
        # rows that do not divide the mesh stay unsharded, as in JAX
        odd = tstk.stack(torch.from_numpy(frames[:, :30]), tstk.StackMode.Sigma, mesh=mesh)
        assert isinstance(odd[0], torch.Tensor)

    def test_sharded_goal_seek_matches(self, mesh, jmesh, rng, interpret):
        frames = _mk_inputs(rng, n=10, h=32, w=128)
        log_s, log_u = io.StringIO(), io.StringIO()
        g_s = tfs.find_sigmas_and_stack(tm.shard_rows(mesh, torch.from_numpy(frames)),
                                        tstk.StackMode.Sigma, mesh=mesh, log=log_s)
        g_u = tfs.find_sigmas_and_stack(torch.from_numpy(frames), tstk.StackMode.Sigma,
                                        log=log_u)
        np.testing.assert_array_equal(_np(g_s[0]), g_u[0].numpy())
        assert g_s[1:] == g_u[1:] and log_s.getvalue() == log_u.getvalue()
        g_j = jfs.find_sigmas_and_stack(
            jax.device_put(jnp.asarray(frames), jm.shard_rows(jmesh)), jstk.StackMode.Sigma,
            mesh=jmesh, use_pallas=True)
        _band(g_s[0], g_j[0])
        assert g_s[1:3] == (int(g_j[1]), int(g_j[2])) and g_s[3:] == (g_j[3], g_j[4])

    def test_sharded_goal_seek_linfit_newton(self, mesh, jmesh, rng, interpret):
        frames = _mk_inputs(rng, n=8, h=16, w=128)
        g_s = tfs.find_sigmas_and_stack(tm.shard_rows(mesh, torch.from_numpy(frames)),
                                        tstk.StackMode.LinearFit, mesh=mesh)
        g_u = tfs.find_sigmas_and_stack(torch.from_numpy(frames), tstk.StackMode.LinearFit)
        np.testing.assert_array_equal(_np(g_s[0]), g_u[0].numpy())
        assert g_s[1:] == g_u[1:]
        g_j = jfs.find_sigmas_and_stack(
            jax.device_put(jnp.asarray(frames), jm.shard_rows(jmesh)),
            jstk.StackMode.LinearFit, mesh=jmesh, use_pallas=True)
        _band(g_s[0], g_j[0])
        assert g_s[1:3] == (int(g_j[1]), int(g_j[2])) and g_s[3:] == (g_j[3], g_j[4])

    @pytest.mark.parametrize("mode", [jstk.StackMode.Sigma, jstk.StackMode.LinearFit])
    def test_sharded_goal_seek_subsampled(self, mesh, jmesh, rng, monkeypatch, mode):
        """The search subsample engaged (its gate lowered in both packages,
        a patch of the test only): each shard subsamples its part of the
        GLOBAL stride-17 pattern of the flattened frame (a shard's 4 x 100
        block holds 400 pixels, 400 % 17 = 9, so each shard starts at its
        own offset), so the shards together count the unsharded
        subsample's clips. Sigmas, clip counts, the steps and the image
        equal the port's unsharded search exactly, and equal the JAX
        package's UNSHARDED search exactly (its _search_subsample takes the
        same global stride-17 pixels). This departs on purpose from JAX's
        sharded search (ROADMAP.md queue 3): its shard_map subsamples each
        local block from its own first pixel, so it evaluates other pixels
        than its unsharded search; against it the sigmas agree to 0.05 and
        the image within test_mesh.py's band."""
        monkeypatch.setattr(jfs, "_SEARCH_SUBSAMPLE_MIN", 64)
        monkeypatch.setattr(tfs, "_SEARCH_SUBSAMPLE_MIN", 64)
        frames = _mk_inputs(rng, n=26, h=32, w=100)
        frames[5, 3:9, 40:60] += 30.0  # a bright patch: clips that vary by shard
        log_s, log_u = io.StringIO(), io.StringIO()
        g_s = tfs.find_sigmas_and_stack(tm.shard_rows(mesh, torch.from_numpy(frames)), mode,
                                        mesh=mesh, log=log_s)
        g_u = tfs.find_sigmas_and_stack(torch.from_numpy(frames), mode, log=log_u)
        np.testing.assert_array_equal(_np(g_s[0]), g_u[0].numpy())
        assert g_s[1:] == g_u[1:] and log_s.getvalue() == log_u.getvalue()
        assert "Step 1:" in log_s.getvalue()
        g_ju = jfs.find_sigmas_and_stack(jnp.asarray(frames), mode, use_pallas=False)
        np.testing.assert_array_equal(_np(g_s[0]), np.asarray(g_ju[0]))
        assert g_s[1:3] == (int(g_ju[1]), int(g_ju[2]))
        assert g_s[3:] == (float(g_ju[3]), float(g_ju[4]))
        g_j = jfs.find_sigmas_and_stack(
            jax.device_put(jnp.asarray(frames), jm.shard_rows(jmesh)), mode, mesh=jmesh,
            use_pallas=False)
        assert abs(g_s[3] - float(g_j[3])) <= 0.05 and abs(g_s[4] - float(g_j[4])) <= 0.05
        _band(g_s[0], g_j[0])
        # what the sharded search evaluated: each shard's part of the
        # global stride-17 sample, the counts summed, equal to the
        # unsharded evaluator's; the sample total the unsharded one
        clips_at, sub_total = tfs._evaluator(torch.from_numpy(frames), mode, None, 0.0, True,
                                             mesh)
        unsharded_at, u_total = tfs._evaluator(torch.from_numpy(frames), mode, None, 0.0, True,
                                               None)
        assert sub_total == u_total
        flat = frames.reshape(26, -1)
        per_shard = [tstk.stack(torch.from_numpy(flat[:, 400 * k:400 * k + 400][
            :, (-400 * k) % 17::17].copy()), mode, sigma_low=2.0, sigma_high=2.0)
            for k in range(8)]
        assert sum(o[0].numel() for o in per_shard) == len(range(0, 3200, 17))
        want = tuple(sum(int(o[i]) for o in per_shard) for i in (1, 2))
        assert clips_at(2.0, 2.0) == want == unsharded_at(2.0, 2.0)


def _same_stars(got, want):
    """Two detections equal exactly: the StarList arrays and the average
    HFR."""
    (gs, gh), (ws, wh) = got, want
    assert gs.count == ws.count
    for name in ("x", "y", "value", "mass", "hfr"):
        np.testing.assert_array_equal(getattr(gs, name), getattr(ws, name), err_msg=name)
    assert gh == wh


def _detect_case(case, rng):
    """(image, detection arguments, max_candidates, shards) of a sharded
    detection case on 256 x 256 frames:

    * boundary: one star's window crosses the boundary of shards 2 and 3
      (rows 80-111 and 64-95 about centre row 95), one centre on a
      boundary row (64), one on the last row of a shard (127), one near
      the frame's top and one near its bottom;
    * ties: the same star (its pixels copied bit for bit) on shards 1 and
      5, and two copies in one shard, so the candidate order breaks equal
      values across shards by the lower flat index;
    * truncation: a threshold of 2 sigma of the noise, hundreds of local
      maxima for a capacity of 64, so the cut falls inside the shards'
      lists;
    * short_shards: 16 shards of 16 rows, whose halo of 32 rows spans two
      neighbours on each side."""
    from tests.test_stars import synth_field

    args = (100.0, 2.0, 10.0)
    if case == "boundary":
        stars = [(40.0, 95.3), (120.0, 64.0), (200.0, 127.0), (60.0, 9.0), (150.0, 248.0),
                 (230.0, 160.0)]
        img = synth_field(rng, stars=stars, flux=5500.0, fwhm=8.0)
        return img, args, 128, 8
    if case == "ties":
        img = synth_field(rng, stars=[(70.0, 50.0)], flux=5500.0, fwhm=8.0)
        patch = img[30:71, 50:91].copy()
        img[170:211, 150:191] = patch   # shard 5, rows 170-210
        img[30:71, 150:191] = patch     # shard 1 again, same rows
        return img, args, 128, 8
    if case == "truncation":
        img = synth_field(rng, stars=[(60.0, 60.0), (190.0, 200.0)], flux=5500.0, fwhm=8.0)
        return img, (100.0, 2.0, 2.0), 64, 8
    stars = [(40.0, 31.5), (120.0, 100.0), (200.0, 176.0), (80.0, 240.0)]
    img = synth_field(rng, stars=stars, flux=5500.0, fwhm=8.0)
    return img, args, 128, 16


class TestShardedDetectAndStretch:
    """Detection and the auto-stretch of a row-sharded image, each shard
    on its rows: the detector with a halo of 2 x radius rows, the
    candidates merged on the lead (K4 on each shard's haloed block on a
    card), the auto-stretch with each round's statistics from the shards.
    Both equal the port's unsharded functions exactly, and JAX's sharded
    ones within the band stated at each test."""

    def test_sharded_star_detect_matches(self, mesh, jmesh, rng):
        from nightlight_tpu_torch.detect.stars import find_stars
        from tests.test_stars import synth_field

        stars = [(40.0, 50.0), (120.0, 80.0), (200.0, 200.0), (60.0, 180.0),
                 (150.0, 30.0), (230.0, 120.0)]
        img = synth_field(rng, h=256, w=256, stars=stars, bg=100.0, noise=2.0,
                          flux=8000.0, fwhm=8.0)
        sharded = tm.place_on_mesh(torch.from_numpy(img), mesh)
        assert not sharded.replicated
        args = (100.0, 2.0, 10.0, 0.0, 1.4, 1.0)
        tm.GATHERS.clear()
        got, hfr = tm.sharded_star_detect(mesh, radius=16, max_candidates=128)(sharded, *args)
        assert not tm.GATHERS
        # the port's unsharded detector: exactly
        _same_stars((got, hfr), find_stars(torch.from_numpy(img), *args[:5], 16, args[5], 128))
        jargs = tuple(jnp.float32(a) for a in args)
        want = jm.sharded_star_detect(jmesh, radius=16, max_candidates=128)(
            jm.place_on_mesh(jnp.asarray(img), jmesh), *jargs)
        # against JAX: counts exactly; positions to 1e-3 px, masses and HFRs
        # to 1e-4 relative: the centre-of-mass sums run in another float32
        # order (tests/test_torch_stars.py)
        assert got.count == int(want[5]) == len(stars)
        n = len(stars)
        np.testing.assert_allclose(got.x, np.asarray(want[0])[:n], atol=1e-3)
        np.testing.assert_allclose(got.y, np.asarray(want[1])[:n], atol=1e-3)
        np.testing.assert_allclose(got.mass, np.asarray(want[3])[:n], rtol=1e-4)
        np.testing.assert_allclose(got.hfr, np.asarray(want[4])[:n], rtol=1e-4)
        assert hfr == pytest.approx(float(want[6]), rel=1e-4)

    @pytest.mark.parametrize("bp_sig", [0.0, 5.0])
    @pytest.mark.parametrize("case", ["boundary", "ties", "truncation", "short_shards"])
    def test_sharded_detector_equals_unsharded(self, case, bp_sig, rng):
        """The sharded detector against find_stars on the whole frame,
        exactly, with no gather; at bp_sig 5 the median-difference stddev
        comes from the shards (None passed to both). Each case's setup
        (_detect_case) is checked too: stars across and on boundaries, a
        tie across shards, the capacity cut, halos over two shards."""
        from nightlight_tpu_torch.detect import stars as tstars

        img, (loc, scale, sig), cap, shards = _detect_case(case, rng)
        mesh = tm.make_mesh([CPU] * shards)
        x = tm.place_on_mesh(torch.from_numpy(img), mesh)
        whole = torch.from_numpy(img)
        cv = tstars._candidate_values(whole, np.float32(loc + scale * sig))
        vals, idx = tstars._select_brightest(cv, cap)
        valid = vals > -np.inf
        if case == "ties":
            v = vals[valid].numpy()
            owners = {int(i) // (256 * 32) for i in idx[valid][np.isin(v, v[0])]}
            assert (v == v[0]).sum() == 3 and owners == {1, 5}
        if case == "truncation":
            assert int((cv > -np.inf).sum()) > 2 * cap and bool(valid.all())
        tm.GATHERS.clear()
        got = tm.sharded_star_detect(mesh, radius=16, max_candidates=cap)(
            x, loc, scale, sig, bp_sig, 1.4, None)
        assert not tm.GATHERS
        want = tstars.find_stars(whole, loc, scale, sig, bp_sig, 1.4, 16, None, cap)
        _same_stars(got, want)
        near = {"boundary": (95.3, 64.0, 127.0), "short_shards": (31.5, 176.0)}.get(case, ())
        for y in near:  # the stars on and across shard boundaries are found
            assert np.abs(got[0].y - y).min() < 1.0, (y, got[0].y)

    def test_merge_top_k_orders_as_the_whole_frame(self, rng):
        """merge_top_k of per-shard stable top-k lists with global indices
        gives _select_brightest's order on the whole frame: values
        descending, ties (many, from integer values) by the lower index,
        cut at the capacity, whatever order the lists come in; -inf entries
        and the padding carry n - 1."""
        from nightlight_tpu_torch.detect import stars as tstars

        h, w, shards, cap = 64, 32, 4, 100
        v = rng.integers(0, 6, size=h * w).astype(np.float32)
        v[rng.random(h * w) < 0.9] = -np.inf
        whole = torch.from_numpy(v)
        want_v, want_i = tstars._select_brightest(whole, cap)
        rows = h // shards
        parts = []
        for k in range(shards):
            pv, pi = tstars._select_brightest(whole[k * rows * w:(k + 1) * rows * w], cap)
            parts.append((pv, pi + k * rows * w))
        m = want_v > -np.inf
        assert int(m.sum()) == cap  # the cut falls inside the candidates
        for order in (parts, parts[::-1]):  # whatever order the lists come in
            got_v, got_i = tm.merge_top_k(order, h * w, cap, CPU)
            np.testing.assert_array_equal(got_v.numpy(), want_v.numpy())
            np.testing.assert_array_equal(got_i[m].numpy(), want_i[m].numpy())
        # fewer candidates than the capacity: -inf and n - 1 after them
        few = [(pv[:3], pi[:3]) for pv, pi in parts]
        fv, fi = tm.merge_top_k(few, h * w, cap, CPU)
        assert fv.shape == (cap,) and bool((fv[12:] == -np.inf).all())
        assert bool((fi[12:] == h * w - 1).all())

    def test_sharded_auto_stretch_matches(self, mesh, jmesh, rng):
        from nightlight_tpu_torch.ops.autostretch import auto_stretch

        img = rng.normal(0.1, 0.01, size=(64, 64)).astype(np.float32).clip(0, 1)
        tm.GATHERS.clear()
        s_out, s_hist, s_n, s_conv = tm.sharded_auto_stretch(mesh, max_iter=8)(
            tm.place_on_mesh(torch.from_numpy(img), mesh), 0.25, 0.05)
        assert not tm.GATHERS
        # the port's unsharded auto-stretch: exactly, the result 8 blocks
        u_out, u_hist, u_n, u_conv = auto_stretch(torch.from_numpy(img), 0.25, 0.05,
                                                  max_iter=8)
        assert (s_n, s_conv) == (u_n, u_conv)
        np.testing.assert_array_equal(s_hist, u_hist)
        np.testing.assert_array_equal(_np(s_out), u_out.numpy())
        j_out, _, j_n, _ = jm.sharded_auto_stretch(jmesh, max_iter=8)(
            jm.place_on_mesh(jnp.asarray(img), jmesh), jnp.float32(0.25), jnp.float32(0.05))
        assert s_n == int(j_n)
        # test_mesh.py's band: the rounds' statistics reduce in another order
        np.testing.assert_allclose(_np(s_out), np.asarray(j_out), rtol=1e-5, atol=1e-6)
        assert len(s_out.blocks) == 8

    @pytest.mark.parametrize("target", [(0.25, 0.05), (0.02, 0.05)], ids=["gamma", "black"])
    def test_sharded_auto_stretch_equals_unsharded(self, mesh, rng, target):
        """A 256 x 256 star field normalised to [0, 1] stretched on 8
        shards: the rounds' history, the pixels and the round count exactly
        the unsharded auto-stretch's, the result still 8 blocks of (32,
        256); the gamma rounds and a black-point shift both taken."""
        from nightlight_tpu_torch.ops import autostretch as ast
        from tests.test_stars import synth_field

        img = synth_field(rng, stars=[(40.0, 50.0), (200.0, 120.0)], bg=1000.0, noise=20.0,
                          flux=80000.0, fwhm=6.0)
        img = ((img - img.min()) / (img.max() - img.min())).astype(np.float32)
        tm.GATHERS.clear()
        s_out, s_hist, s_n, s_conv = tm.sharded_auto_stretch(mesh)(
            tm.place_on_mesh(torch.from_numpy(img), mesh), *target)
        assert not tm.GATHERS
        u_out, u_hist, u_n, u_conv = ast.auto_stretch(torch.from_numpy(img), *target)
        assert (s_n, s_conv) == (u_n, u_conv) and s_n > 1
        np.testing.assert_array_equal(s_hist, u_hist)
        np.testing.assert_array_equal(_np(s_out), u_out.numpy())
        assert [tuple(b.shape) for b in s_out.blocks] == [(32, 256)] * 8
        acts = set(s_hist[:, ast.H_ACTION].tolist())
        assert (ast.ACT_GAMMA if target[0] == 0.25 else ast.ACT_BLACK) in acts

    def test_place_on_mesh_replicates_indivisible_rows(self, mesh, jmesh):
        odd = tm.place_on_mesh(torch.zeros(63, 16), mesh)
        assert odd.replicated and odd.spec == ()
        assert jm.place_on_mesh(jnp.zeros((63, 16)), jmesh).sharding.is_fully_replicated
        even = tm.place_on_mesh(torch.zeros(3, 64, 16), mesh)  # (C, H, W)
        assert not even.replicated and even.spec == (None, "pix", None)
        assert not jm.place_on_mesh(jnp.zeros((3, 64, 16)), jmesh).sharding.is_fully_replicated


_JOB_STEPS = [
    {"type": "loadMany", "filePatterns": ["light*.fits"]},
    {"type": "badPixel", "sigmaLow": 3.0, "sigmaHigh": 5.0},
    {"type": "starDetect", "radius": 16, "sigma": 10.0,
     "badPixelSigma": 5.0, "inOutRatio": 1.4},
    {"type": "selectRef", "target": 1, "mode": "%starsHFR"},
    {"type": "selectRef", "target": 0, "mode": "%starsHFR"},
    {"type": "matchHist", "mode": 2},
    {"type": "align", "k": 20, "threshold": 1.0, "oobMode": 0},
]


def _run_job(tmp_path, out, mesh, jax_side=False, stack=None):
    """test_mesh.py's context job (load -> bad pixel -> detect -> select ref
    -> match -> align -> stack mode 2 at sigma 2.75 -> save) through either
    package, with c.mesh set or not. Returns the log."""
    stack = stack or {"type": "stack", "mode": 2, "sigmaLow": 2.75, "sigmaHigh": 2.75}
    job = {"type": "seq", "steps": [*_JOB_STEPS, stack,
                                     {"type": "save", "filePattern": str(tmp_path / out)}]}
    log = io.StringIO()
    if jax_side:
        from nightlight_tpu.pipeline import materialize_all, op_from_dict
        from nightlight_tpu.pipeline.context import new_context

        # serialize device work, as test_mesh.py does for its 8-way programs
        os.environ["NIGHTLIGHT_SYNC_FLUSH"] = "1"
        c = new_context(log=log)
    else:
        from nightlight_tpu_torch.pipeline import materialize_all, op_from_dict
        from nightlight_tpu_torch.pipeline.context import new_context

        c = new_context(log=log, device="cpu")
    c.mesh = mesh
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        promises = op_from_dict(job).make_promises([], c)
        if jax_side:
            _, err = materialize_all(promises, c.max_threads, True)
        else:
            _, err = materialize_all(promises, forget=True)
        if err is not None:
            raise err
        c.finalize()
    finally:
        os.chdir(cwd)
        os.environ.pop("NIGHTLIGHT_SYNC_FLUSH", None)
    return log.getvalue()


def _frame_lines_sorted(log):
    """Log lines without the per-frame order of the JAX thread pool."""
    return sorted(ln for ln in log.splitlines() if ln.strip())


class TestMeshContextPipeline:
    """Context.mesh: frames are row-sharded at load and the per-frame
    operators run on each shard's rows; the stack builds the batch from
    each device's blocks. The sharded job equals the unsharded one."""

    def test_full_job_sharded_matches_unsharded(self, mesh, jmesh, rng, tmp_path):
        from nightlight_tpu_torch.io import fits as tfits
        from tests.test_pipeline_e2e import write_frames

        write_frames(tmp_path, rng, n_frames=4)
        log_s = _run_job(tmp_path, "sharded.fits", mesh)
        log_u = _run_job(tmp_path, "unsharded.fits", None)
        _run_job(tmp_path, "jax_sharded.fits", jmesh, jax_side=True)
        assert "Stacking 4 frames" in log_s
        # the same log: clip counts, statistics, every line
        assert log_s.replace("sharded.fits", "X") == log_u.replace("unsharded.fits", "X")

        a, b, j = (tfits.read_file(str(tmp_path / name)).to_numpy()
                   for name in ("sharded.fits", "unsharded.fits", "jax_sharded.fits"))
        # sharded and unsharded port runs warp alike (the shift-blend warp
        # of each frame, on the batch or frame by frame): bit for bit
        np.testing.assert_array_equal(a, b)
        # against the JAX package: test_mesh.py's band (transforms from
        # centroids that differ at ~1e-5 px, tests/test_torch_cli.py)
        m = ~(np.isnan(a) | np.isnan(j))
        assert m.mean() > 0.9
        np.testing.assert_allclose(a[m], j[m], rtol=1e-4, atol=1e-3)

    def test_star_detect_keeps_the_kernel_path_under_mesh(self, mesh, rng, tmp_path,
                                                          monkeypatch):
        """JAX forces the XLA gather under a mesh (a pallas_call cannot
        address global rows of a sharded frame). The port's frame is
        row-sharded at load and detection runs on the shards
        (parallel/mesh.py sharded_star_detect): K4's wrapper
        (gather_cuda.gather_patches: the kernel on a card) sees each
        shard's block with its halo of 2 x radius = 32 rows, (64, 256) at
        the frame's first and last shard and (96, 256) between, once for
        each shard that holds a candidate's centre row and for no other.
        Nothing is gathered, the stars equal the unsharded detector's and
        the frame stays sharded."""
        from nightlight_tpu_torch.detect import stars as tstars
        from nightlight_tpu_torch.pipeline import ops_pre
        from nightlight_tpu_torch.pipeline.context import new_context
        from nightlight_tpu_torch.pipeline.operators import OpLoad
        from tests.test_pipeline_e2e import write_frames

        names = write_frames(tmp_path, rng, n_frames=1)
        c = new_context(log=io.StringIO(), device="cpu")
        c.mesh = mesh
        f = OpLoad(id=0, file_name=names[0]).apply(None, c)
        whole = tm.gather(f.data)
        seen = []
        real = tstars.gather_patches

        def spy(img, *args):
            seen.append(tuple(img.shape))
            return real(img, *args)

        monkeypatch.setattr(tstars, "gather_patches", spy)
        assert isinstance(f.data, tm.RowSharded) and len(f.data.blocks) == 8
        tm.GATHERS.clear()
        op = ops_pre.OpStarDetect(radius=16, sigma=10.0, bad_pixel_sigma=5.0, in_out_ratio=1.4)
        op.apply(f, c)
        assert not tm.GATHERS and f.stars.count > 0
        # the shards that hold a candidate's centre row, from the unsharded
        # candidate list
        thr = np.float32(f.stats.location) + np.float32(f.stats.scale) * np.float32(10.0)
        vals, idx = tstars._select_brightest(tstars._candidate_values(whole, thr), 2048)
        owners = sorted({int(i) // (32 * 256) for i in idx[vals > -np.inf]})
        assert 1 < len(owners) <= 8
        assert seen == [(64 if k in (0, 7) else 96, 256) for k in owners]
        want = tstars.find_stars(whole, f.stats.location, f.stats.scale, 10.0, 5.0, 1.4, 16,
                                 f.median_diff_stats.stddev if f.median_diff_stats else None)
        _same_stars((f.stars, f.hfr), want)
        assert isinstance(f.data, tm.RowSharded) and len(f.data.blocks) == 8

    def test_loaded_frame_is_whole_and_the_batch_row_sharded(self, mesh, rng, tmp_path):
        """JAX row-shards each frame at load, and so does the port: each
        loaded frame holds one (32, 256) block per mesh device, and
        OpStack._batch_frames stacks each device's blocks into its block of
        the cube without a gather."""
        from nightlight_tpu_torch.pipeline.context import new_context
        from nightlight_tpu_torch.pipeline.operators import OpLoad
        from nightlight_tpu_torch.pipeline.ops_stack import OpStack
        from tests.test_pipeline_e2e import write_frames

        names = write_frames(tmp_path, rng, n_frames=2)
        c = new_context(log=io.StringIO(), device="cpu")
        c.mesh = mesh
        assert c.device == mesh.lead
        fs = [OpLoad(id=i, file_name=n).apply(None, c) for i, n in enumerate(names)]
        assert all(isinstance(f.data, tm.RowSharded) and f.data.shape == (256, 256)
                   and [b.shape for b in f.data.blocks] == [(32, 256)] * 8 for f in fs)
        blocks = [list(f.data.blocks) for f in fs]
        tm.GATHERS.clear()
        batch = OpStack._batch_frames(fs, c)
        assert isinstance(batch, tm.RowSharded) and len(batch.blocks) == 8
        assert all(b.shape == (2, 32, 256) for b in batch.blocks)
        assert not tm.GATHERS
        for k, b in enumerate(batch.blocks):
            assert torch.equal(b, torch.stack([blocks[0][k], blocks[1][k]]))


# ---------------------------------------------------------------------------
# The port's own routing checks
# ---------------------------------------------------------------------------


def test_fused_executor_off_under_mesh(mesh, jmesh, rng, tmp_path, monkeypatch):
    """Under a mesh a stackBatches job built by the `stack` preset takes the
    per-frame operator path with the JAX package's line, and stacks per
    shard with the goal-seek."""
    from nightlight_tpu.models import fastpath as jfast
    from nightlight_tpu_torch import cli as tcli
    from nightlight_tpu_torch.models import fastpath as tfast
    from nightlight_tpu_torch.pipeline.context import new_context
    from tests.test_pipeline_e2e import write_frames

    class C:
        pass

    for mod, m in ((tfast, mesh), (jfast, jmesh)):
        c = C()
        c.mesh = m
        assert mod.fused_batch_eligible([], c) == (False, "sharded run (mesh active)")

    write_frames(tmp_path, rng, n_frames=6)
    monkeypatch.chdir(tmp_path)
    args = tcli.build_parser().parse_args(["-out", "s.fits", "-jpg", "", "stack",
                                           "light*.fits"])
    tcli.apply_command_defaults(args)
    log = io.StringIO()
    c = new_context(log=log, device="cpu")
    c.mesh = mesh
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.run_op(tcli.build_command_seq(args), c)
    text = log.getvalue()
    assert ("Fused batch executor off (sharded run (mesh active)); using the per-frame "
            "operator path.\n") in text
    assert "Stacking 6 frames with stacking mode 2 " in text
    assert re.search(r"Reached 0\.50% and 0\.50% clipping", text)


@pytest.mark.parametrize("mode,sigmas", [(2, (2.75, 2.75)), (5, (-1.0, -1.0)),
                                         (0, (2.75, 2.75)), (1, (2.75, 2.75)),
                                         (3, (-1.0, -1.0)), (4, (2.75, 2.75))])
def test_context_job_sharded_equals_unsharded(mesh, rng, tmp_path, mode, sigmas):
    """The sharded context job against the unsharded one on the port alone,
    in every stacking mode: equal log lines (clip counts, goal-seek steps)
    and the image bit for bit: both runs warp each frame with the same
    shift-blend arithmetic, and the stack is per pixel. Modes 3 and 5 run
    the sharded goal-seek (binary and Newton); the median and the mean clip
    nothing."""
    from nightlight_tpu_torch.io import fits as tfits
    from tests.test_pipeline_e2e import write_frames

    write_frames(tmp_path, rng, n_frames=6, h=128, w=96)
    stack = {"type": "stack", "mode": mode, "sigmaLow": sigmas[0], "sigmaHigh": sigmas[1]}
    log_s = _run_job(tmp_path, "a.fits", mesh, stack=stack)
    log_u = _run_job(tmp_path, "b.fits", None, stack=stack)
    assert log_s.replace("a.fits", "X") == log_u.replace("b.fits", "X")
    assert f"with stacking mode {mode} " in log_s
    assert ("Clipped low" in log_s) == (mode >= 2)
    a = tfits.read_file(str(tmp_path / "a.fits")).to_numpy()
    b = tfits.read_file(str(tmp_path / "b.fits")).to_numpy()
    np.testing.assert_array_equal(a, b)


def test_require_cuda_takes_any_card():
    """The kernels run on any cuda:k: require_cuda refuses only what is not
    a contiguous CUDA tensor of the type, and every launching C entry sets
    its device first (NL_USE_DEVICE) and takes (device, stream) last."""
    from types import SimpleNamespace

    from nightlight_tpu_torch import kernels

    for k in (0, 1, 3):
        t = SimpleNamespace(device=torch.device("cuda", k), dtype=torch.float32,
                            is_contiguous=lambda: True)
        kernels.require_cuda(t, "x", torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.require_cuda(torch.zeros(2), "x", torch.float32)
    entries = 0
    for src in sorted(kernels.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (nl_\w+)\(([^)]*)\) \{\n(.*)\n', text):
            name, params, first = m.groups()
            assert first.strip() == "NL_USE_DEVICE(device);", name
            assert re.search(r"int device,\s+(void\* stream|int\* blocks)$", params), name
            entries += 1
    assert entries == 11
