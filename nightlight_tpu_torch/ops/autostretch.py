"""Iterative auto-stretch, mirror of nightlight_tpu/ops/autostretch.py
(reference: internal/ops/stretch/stretch.go:103-159): estimate location and
scale, pick a gamma or a black-point shift, apply it, repeat (at most 50
rounds). The JAX package runs the search as one device while_loop; the port
runs the same rounds as a host loop over device tensors, with one read-back
a round (the decision). A (rounds, 7) history of [loc, scale, min, mean,
max, action, param] lets the caller print the reference's per-round lines.
"""

from __future__ import annotations

import numpy as np
import torch

from nightlight_tpu_torch.ops.stats import location_scale, min_mean_max
from nightlight_tpu_torch.parallel import mesh as pm

# history row layout
H_LOC, H_SCALE, H_MIN, H_MEAN, H_MAX, H_ACTION, H_PARAM = range(7)
# action codes
ACT_GAMMA, ACT_BLACK, ACT_DONE_GAMMA, ACT_DONE = 0.0, 1.0, 2.0, 3.0

# the gamma candidates of the search, [1, 5] in steps of 0.01
_GAMMAS = np.arange(1.0, 5.0 + 1e-9, 0.01, dtype=np.float32)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).to(device)


def _ideal_gamma(loc, scale, target_loc, target_scale):
    """Gamma in [1, 5] step 0.01 minimizing the post-stretch scale error
    (stretch.go:118-140), as float32 vector math. Go's quirk stays: when
    loc < scale, pow(loc - scale, 1/gamma) is NaN for every candidate,
    max(0, NaN) keeps it, no candidate beats the baseline, and the search
    returns gamma 1."""
    dev = loc.device
    gammas = torch.from_numpy(_GAMMAS).to(dev)
    exponent = 1.0 / gammas
    new_loc_lower = torch.pow(loc - scale, exponent)
    new_loc = torch.pow(loc, exponent)
    new_loc_upper = torch.pow(loc + scale, exponent)
    black = (target_loc - new_loc) / (target_loc - 1.0)
    s = 1.0 / (1.0 - black)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # torch.maximum propagates NaN, like Go's math.Max
    lower = torch.maximum(zero, (new_loc_lower - black) * s)
    upper = torch.maximum(zero, (new_loc_upper - black) * s)
    delta = (target_scale - (upper - lower) / 2.0).abs()
    best = torch.argmin(delta)
    return torch.where(delta[best] < (target_scale - scale).abs(), gammas[best], zero + 1.0)


def stretch_decision(loc, scale, target_loc, target_scale):
    """One round of the reference's branch logic (stretch.go:117-155):
    (action, param) as 0-d float32 tensors, action one of the ACT_* codes,
    param the gamma (ACT_GAMMA) or the location the black shift moves to
    the target (ACT_BLACK)."""
    gamma = _ideal_gamma(loc, scale, target_loc, target_scale)
    cond1 = (loc <= target_loc * 1.01) & (scale < target_scale)
    cond2 = ~cond1 & (loc > target_loc * 0.99) & (scale < target_scale)
    code = lambda v: _f32(v, loc.device)  # noqa: E731
    action = torch.where(cond1 & (gamma > 1.01), code(ACT_GAMMA),
                         torch.where(cond1, code(ACT_DONE_GAMMA),
                                     torch.where(cond2, code(ACT_BLACK), code(ACT_DONE))))
    param = torch.where(action == ACT_GAMMA, gamma,
                        torch.where(action == ACT_BLACK, loc, code(0.0)))
    return action, param


def auto_stretch(data, target_loc, target_scale, max_iter: int = 50):
    """The full iterative stretch. Returns (stretched, history, n_iter,
    converged): history a host (n_iter, 7) float32 array; converged False
    when the loop made max_iter transforms and still wanted to continue
    (the reference's 50-iteration warning).

    `data` may be row-sharded (parallel/mesh.py RowSharded): each round's
    statistics then come from the shards (min_max, sum64 and the sampled
    estimator's take_flat, as ops/stats.py reads them), the lead decides,
    and the transform runs on each block, the result row-sharded; the
    same pixels and history as the whole image gives."""
    dev = data.device
    tl, ts = _f32(target_loc, dev), _f32(target_scale, dev)
    rows = []
    d = data
    running = True
    while running and len(rows) < max_iter:
        flat = d if isinstance(d, pm.RowSharded) else d.reshape(1, -1)
        mn, me, mx = (v.reshape(1) for v in min_mean_max(flat))
        loc, scale = location_scale(flat, mn, mx)
        loc, scale = loc[0], scale[0]
        action, param = stretch_decision(loc, scale, tl, ts)
        row = torch.stack([loc, scale, mn[0], me[0], mx[0], action, param]).cpu().numpy()
        rows.append(row)
        act = float(row[H_ACTION])
        if act == ACT_GAMMA:
            exponent = 1.0 / param
            d = pm.per_block(lambda b: torch.pow(b, pm._to(exponent, b.device)), d)
        elif act == ACT_BLACK:
            black = (tl - loc) / (tl - 1.0)
            bscale = 1.0 / (1.0 - black)
            d = pm.per_block(lambda b: ((b - pm._to(black, b.device))
                                        * pm._to(bscale, b.device)).clamp(min=0.0), d)
        running = act in (ACT_GAMMA, ACT_BLACK)
    return d, np.stack(rows).astype(np.float32), len(rows), not running
