"""The port's clip stacking held directly against the pure-NumPy Go oracles
of tests/test_go_oracles.py (reference stack.go clip loops), on the same
fixture the JAX package is held against there."""

import numpy as np
import pytest
import torch

from nightlight_tpu_torch.ops import stack as tstk
from test_go_oracles import go_stack_clip_oracle, go_stack_clip_weighted_oracle

torch.set_num_threads(1)

REF_LOC = 1234.5


def _clip_frames():
    """test_go_oracles.clip_frames: 10 frames x 96 px, outliers, NaN drops,
    one all-NaN and one constant pixel; no sample sits within float eps of
    a clip bound, so counts and means must match exactly."""
    rng = np.random.default_rng(0)
    n, p = 10, 96
    f = rng.normal(1000.0, 10.0, size=(n, p)).astype(np.float32)
    f[rng.uniform(size=(n, p)) < 0.06] += 300.0
    f[rng.uniform(size=(n, p)) < 0.04] -= 250.0
    f[rng.uniform(size=(n, p)) < 0.08] = np.nan
    f[:, 17] = np.nan
    f[:, 33] = 500.0
    return f


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode,sig", [
    (tstk.StackMode.Sigma, (2.0, 2.0)), (tstk.StackMode.Sigma, (1.5, 3.0)),
    (tstk.StackMode.WinsorSigma, (2.0, 2.0)), (tstk.StackMode.WinsorSigma, (1.2, 2.6))])
def test_clip_stack_matches_go_oracle(mode, sig, weighted):
    """Clip counts exactly; values within the band the JAX package's own
    oracle tests use (rtol 2e-5, atol 2e-2: the oracle sums in numpy's
    pairwise order, the port sequentially)."""
    frames = _clip_frames()
    winsorize = mode == tstk.StackMode.WinsorSigma
    if weighted:
        weights = np.random.default_rng(7).uniform(0.2, 1.0, frames.shape[0]).astype(np.float32)
        ref, rcl, rch = go_stack_clip_weighted_oracle(frames, weights, REF_LOC, sig[0], sig[1],
                                                      winsorize)
        w = torch.from_numpy(weights)
    else:
        ref, rcl, rch = go_stack_clip_oracle(frames, REF_LOC, sig[0], sig[1], winsorize)
        w = None
    out, cl, ch = tstk.stack(torch.from_numpy(frames), mode, weights=w, sigma_low=sig[0],
                             sigma_high=sig[1], ref_frame_loc=REF_LOC)
    assert int(cl) == rcl and int(ch) == rch
    assert float(out[17]) == REF_LOC  # the all-NaN pixel
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-2)


# ---------------------------------------------------------------------------
# The colour balance and the curves the HSL operators reuse, held against
# the oracles of the JAX package's colour-balance and point-op tests, with
# their tolerances
# ---------------------------------------------------------------------------


def test_darkest_block_matches_go_oracle():
    from nightlight_tpu_torch.ops.rgb import find_darkest_block
    from test_go_oracles import go_find_darkest_block_oracle

    rng = np.random.default_rng(42)
    cube = rng.uniform(0.0, 1.0, size=(3, 48, 64)).astype(np.float32)
    cube[:, 32:40, 16:24] *= 0.05  # an unambiguous darkest block
    for block, border in ((8, 0.1), (16, 0.1), (8, 0.0), (8, 0.25)):
        got = find_darkest_block(torch.from_numpy(cube), block, border).numpy()
        ref = go_find_darkest_block_oracle(cube, block, border)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _oracle_stars(rng, h, w, n):
    from nightlight_tpu_torch.detect.stars import StarList

    xs = rng.integers(2, w - 3, n)
    ys = rng.integers(2, h - 3, n)
    xs[0], ys[0] = 0, 0  # corner star: window clipped
    hfrs = rng.uniform(1.0, 4.0, n).astype(np.float32)
    stars = StarList(x=xs.astype(np.float32), y=ys.astype(np.float32),
                     value=np.ones(n, np.float32), mass=np.linspace(900, 100, n).astype(np.float32),
                     hfr=hfrs, count=n)
    return stars, list(zip(xs.tolist(), ys.tolist(), hfrs.tolist()))


@pytest.mark.parametrize("skip", [(0.0, 0.0), (0.2, 0.1)])
def test_mean_star_intensity_matches_go_oracle(skip):
    """The host loop and the device version (K4's plain version on the
    CPU) against meanStarIntensity's oracle."""
    from nightlight_tpu_torch.ops.rgb import mean_star_intensity, mean_star_intensity_device
    from test_go_oracles import go_mean_star_intensity_oracle

    rng = np.random.default_rng(42)
    h, w = 40, 56
    cube = rng.uniform(0.0, 1000.0, size=(3, h, w)).astype(np.float32)
    stars, triples = _oracle_stars(rng, h, w, 9)
    clip = (900.0, 920.0, 940.0)
    ref = go_mean_star_intensity_oracle(cube, triples, *skip, clip)
    got = mean_star_intensity(cube, stars, *skip, clip)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-4)
    dev = mean_star_intensity_device(torch.from_numpy(cube), stars, *skip, clip).numpy()
    np.testing.assert_allclose(dev, ref, rtol=2e-5, atol=1e-4)


def test_all_star_pixels_clipped_gives_zeros_not_go_nan():
    """Go's 1/0 norm gives NaN when every star pixel is clipped
    (rgb.go:279-280); the port returns zeros, as the JAX package does."""
    from nightlight_tpu_torch.detect.stars import StarList
    from nightlight_tpu_torch.ops.rgb import mean_star_intensity, mean_star_intensity_device
    from test_go_oracles import go_mean_star_intensity_oracle

    cube = np.full((3, 16, 16), 500.0, np.float32)
    stars = StarList(x=np.array([8.0], np.float32), y=np.array([8.0], np.float32),
                     value=np.ones(1, np.float32), mass=np.array([100.0], np.float32),
                     hfr=np.array([2.0], np.float32), count=1)
    clip = (1.0, 1.0, 1.0)
    assert all(np.isnan(v) for v in go_mean_star_intensity_oracle(cube, [(8, 8, 2.0)], 0.0,
                                                                   0.0, clip))
    assert mean_star_intensity(cube, stars, 0.0, 0.0, clip) == (0.0, 0.0, 0.0)
    dev = mean_star_intensity_device(torch.from_numpy(cube), stars, 0.0, 0.0, clip)
    assert dev.tolist() == [0.0, 0.0, 0.0]


def test_black_white_correction_matches_go_oracle():
    from nightlight_tpu_torch.ops.rgb import RGB, black_white_correction
    from test_go_oracles import go_black_white_correction_oracle

    rng = np.random.default_rng(42)
    cs = rng.uniform(0.01, 0.1, 3).astype(np.float32)
    ch = rng.uniform(0.5, 0.9, 3).astype(np.float32)
    alpha, beta = black_white_correction(tuple(cs), tuple(ch), RGB(1.0, 1.0, 1.0),
                                         RGB(1.0, 1.0, 1.0))
    oalpha, obeta = go_black_white_correction_oracle(cs, ch, (1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    np.testing.assert_allclose(alpha, oalpha, rtol=1e-6)
    np.testing.assert_allclose(beta, obeta, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mid,black", [(0.25, 0.05), (0.4, 0.0), (0.15, 0.12)])
def test_midtones_matches_go_oracle(mid, black):
    """pfMidtones with its pre-clip quirk (out-of-range values land at
    -clipLow*scaler and scaler, not 0 and 1)."""
    from nightlight_tpu_torch.ops.pixelmath import midtones
    from test_go_oracles import go_midtones_oracle

    d = np.random.default_rng(42).uniform(0.0, 1.0, 2048).astype(np.float32)
    d[:8] = [0.0, 1.0, 0.001, 0.999, 0.25, 0.5, 0.75, 0.1]
    got = midtones(torch.from_numpy(d), mid, black).numpy()
    np.testing.assert_allclose(got, go_midtones_oracle(d, mid, black), rtol=2e-5, atol=2e-6)


def test_partial_gamma_matches_go_oracle():
    from nightlight_tpu_torch.ops.pixelmath import partial_gamma
    from test_go_oracles import go_partial_gamma_oracle

    d = np.random.default_rng(42).uniform(0.0, 1.0, 2048).astype(np.float32)
    from_, to, g = 0.3, 1.0, 2.2
    d[:4] = [from_, to, 0.3000001, 0.9999999]  # boundary passthrough
    got = partial_gamma(torch.from_numpy(d), from_, to, g).numpy()
    np.testing.assert_allclose(got, go_partial_gamma_oracle(d, from_, to, g), rtol=2e-5,
                               atol=2e-6)
    assert got[0] == d[0] and got[1] == d[1]


def test_shift_black_matches_go_oracle():
    from nightlight_tpu_torch.ops.pixelmath import shift_black_to_move
    from test_go_oracles import go_shift_black_oracle

    d = np.random.default_rng(42).uniform(0.0, 1.0, 1024).astype(np.float32)
    got = shift_black_to_move(torch.from_numpy(d), 0.2, 0.1).numpy()
    np.testing.assert_allclose(got, go_shift_black_oracle(d, 0.2, 0.1), rtol=2e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The estimators, the reference selection and the stretch decision, held
# against the oracles of the JAX package's tests with their tolerances
# ---------------------------------------------------------------------------


def test_sigma_clipped_median_qn_matches_go_oracle_and_keeps_the_quirk():
    """-lsEst 3 on 35% contamination at +6 sigma: the port tracks the
    quirk oracle (both bounds at sigma_low), not the non-quirk one, and
    returns the unbounded Qn of the whole sample (PRNGKey(11), 16384
    samples, as the JAX package's test)."""
    from nightlight_tpu_torch.ops.stats import sigma_clipped_median_qn
    from test_go_oracles import go_sigma_clipped_median_qn_oracle

    rng = np.random.default_rng(42)
    data = np.concatenate([rng.normal(100.0, 2.0, size=2600),
                           rng.normal(112.0, 2.0, size=1400)]).astype(np.float32)
    rng.shuffle(data)
    loc, scale = sigma_clipped_median_qn(torch.from_numpy(data), 2.0, num_samples=16384,
                                         seed=11)
    loc, scale = float(loc), float(scale)
    oloc, oscale = go_sigma_clipped_median_qn_oracle(np.float64(data), 2.0, 8.0, quirk=True)
    nloc, _ = go_sigma_clipped_median_qn_oracle(np.float64(data), 2.0, 8.0, quirk=False)
    assert abs(nloc - oloc) > 0.5
    assert loc == pytest.approx(oloc, abs=0.3)
    assert abs(loc - oloc) < abs(loc - nloc)
    assert scale == pytest.approx(oscale, rel=0.15)


def test_sigma_clipped_median_qn_clean_gaussian_matches_go_oracle():
    from nightlight_tpu_torch.ops.stats import sigma_clipped_median_qn
    from test_go_oracles import go_sigma_clipped_median_qn_oracle

    data = np.random.default_rng(42).normal(500.0, 7.0, size=4000).astype(np.float32)
    loc, scale = sigma_clipped_median_qn(torch.from_numpy(data), 2.0, num_samples=16384, seed=3)
    oloc, oscale = go_sigma_clipped_median_qn_oracle(np.float64(data), 2.0, 2.0)
    assert float(loc) == pytest.approx(oloc, abs=0.35)
    assert float(scale) == pytest.approx(oscale, rel=0.1)
    assert float(scale) == pytest.approx(7.0, rel=0.12)


@pytest.mark.parametrize("n,contaminated,abs_loc,rel_scale", [
    (2000, False, 1e-3, 1e-3), (2001, False, 1e-3, 1e-3), (3000, True, 2e-3, 2e-3)])
def test_ikss_matches_go_oracle(n, contaminated, abs_loc, rel_scale):
    """IKSS (-lsEst 2) against the oracle of stats.go:535-566, clean and
    with 200 bright samples the window shrink rejects."""
    from nightlight_tpu_torch.ops.stats import ikss
    from test_go_oracles import go_ikss_oracle

    data = np.random.default_rng(42).normal(100.0, 5.0, size=n).astype(np.float32)
    if contaminated:
        data[:200] += 400.0
    loc, scale = ikss(torch.from_numpy(data))
    oloc, oscale = go_ikss_oracle(data)
    assert float(loc) == pytest.approx(oloc, abs=abs_loc)
    assert float(scale) == pytest.approx(oscale, rel=rel_scale)
    if contaminated:
        assert abs(oscale - 5.0) < 1.0


def test_ikss_constant_window_is_a_go_hang_the_port_guards():
    """The reference loops forever on a constant window (the oracle gives
    up after max_iter); the port returns (value, scale 0), as the JAX
    package does."""
    from nightlight_tpu_torch.ops.stats import ikss
    from test_go_oracles import go_ikss_oracle

    data = np.full(512, 7.25, np.float32)
    oloc, _ = go_ikss_oracle(data, max_iter=50)
    assert oloc is None
    loc, scale = ikss(torch.from_numpy(data))
    assert float(loc) == 7.25 and float(scale) == 0.0


def _hist_cases():
    rng = np.random.default_rng(42)
    gauss = np.clip(rng.normal(0.3, 0.02, size=4096).astype(np.float32), 0.0, 1.0)
    edge = np.concatenate([np.full(500, 0.01, np.float32),
                           rng.uniform(0.0, 1.0, 1500).astype(np.float32)])
    single = np.full(1000, 0.5, np.float32)
    single[0], single[-1] = 0.0, 1.0
    return [(gauss, float(gauss.min()), float(gauss.max()), 64),
            (gauss, float(gauss.min()), float(gauss.max()), 256),
            (edge, 0.0, 1.0, 64),      # the peak in bin 1 clamps the ring walk
            (single, 0.0, 1.0, 64)]    # the peak bin alone covers one sigma


@pytest.mark.parametrize("case", range(4))
def test_histogram_scale_loc_matches_go_oracle(case):
    """-lsEst 4's histogram peak and ring half-width (stats.go:640-688)."""
    from nightlight_tpu_torch.ops.stats import histogram_scale_loc
    from test_go_oracles import go_histogram_scale_loc_oracle

    data, vmin, vmax, bins = _hist_cases()[case]
    loc, scale = histogram_scale_loc(torch.from_numpy(data), torch.tensor(np.float32(vmin)),
                                     torch.tensor(np.float32(vmax)), bins)
    oloc, oscale = go_histogram_scale_loc_oracle(data, vmin, vmax, bins)
    assert float(loc) == pytest.approx(oloc, abs=1e-6)
    assert float(scale) == pytest.approx(oscale, abs=1e-6)


def test_estimate_noise_matches_go_oracle():
    """Immerkaer noise (noise.go:32-55) on noise and on a clean gradient."""
    from nightlight_tpu_torch.ops.stats import estimate_noise
    from test_go_oracles import go_estimate_noise_oracle

    img = np.random.default_rng(42).normal(100.0, 3.0, size=(24, 32)).astype(np.float32)
    assert float(estimate_noise(torch.from_numpy(img))) == pytest.approx(
        go_estimate_noise_oracle(img), rel=1e-4)
    grad = np.outer(np.arange(24, dtype=np.float32), np.ones(32, np.float32))
    assert float(estimate_noise(torch.from_numpy(grad))) == pytest.approx(
        go_estimate_noise_oracle(grad), abs=1e-6)


@pytest.mark.parametrize("locs", [
    [0.11, 0.09, 0.10, 0.30, 0.05],
    [0.2, 0.1],
    [1.0],
    [0.5, float("nan"), 0.1, 0.11],
    [float("nan"), float("nan"), 7.0],
])
def test_select_median_loc_matches_go_oracle(locs):
    """%location reference selection (refframe.go:229-258): NaN frames
    dropped from the median and never chosen."""
    from types import SimpleNamespace

    from nightlight_tpu_torch.pipeline.ops_ref import _select_median_loc
    from test_go_oracles import go_select_median_loc_oracle

    frames = [SimpleNamespace(id=i, stats=SimpleNamespace(location=v))
              for i, v in enumerate(locs)]
    frame, median = _select_median_loc(frames)
    oidx, omedian = go_select_median_loc_oracle(locs)
    assert frame.id == oidx
    assert median == pytest.approx(omedian, rel=1e-6)


def test_select_median_loc_all_nan_raises_like_go():
    from types import SimpleNamespace

    from nightlight_tpu_torch.pipeline.ops_ref import _select_median_loc

    with pytest.raises(ValueError):
        _select_median_loc([SimpleNamespace(id=i, stats=SimpleNamespace(location=float("nan")))
                            for i in range(3)])


def _stretch_decisions():
    rng = np.random.default_rng(42)
    fixed = [(0.05, 0.0015), (0.2, 0.001), (0.05, 0.005), (0.001, 0.003)]
    return fixed + [(float(rng.uniform(0.0005, 0.3)), float(rng.uniform(0.0002, 0.008)))
                    for _ in range(60)]


def test_stretch_decision_matches_go_oracle():
    """One auto-stretch round (stretch.go:117-155) at the OpStretchIterative
    targets: a gamma round, a black shift, done, the NaN quirk (loc below
    scale: gamma 1, done) and a randomized sweep. The action exactly; a
    gamma within one 0.01 step of the oracle's float32 grid (the port
    searches an arange grid, as the JAX package), a black shift's location
    within 1e-6."""
    from nightlight_tpu_torch.ops.autostretch import (ACT_BLACK, ACT_DONE, ACT_DONE_GAMMA,
                                                      ACT_GAMMA, stretch_decision)
    from test_go_oracles import go_stretch_decision_oracle

    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    actions = []
    for loc, scale in _stretch_decisions():
        a, p = stretch_decision(f32(loc), f32(scale), f32(0.1), f32(0.004))
        oa, op_ = go_stretch_decision_oracle(loc, scale, 0.1, 0.004)
        assert float(a) == oa, (loc, scale)
        if oa == ACT_GAMMA:
            assert abs(float(p) - op_) <= 0.0101, (loc, scale)
        elif oa == ACT_BLACK:
            assert float(p) == pytest.approx(op_, rel=1e-6)
        actions.append(oa)
    assert actions[:4] == [ACT_GAMMA, ACT_BLACK, ACT_DONE, ACT_DONE_GAMMA]
