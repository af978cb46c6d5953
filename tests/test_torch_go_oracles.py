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
