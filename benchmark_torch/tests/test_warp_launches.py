"""CPU test of the warp.launches reader (benchmark_torch/metrics/) on
hand-made records of a traced run.

    python -m pytest benchmark_torch/tests/test_warp_launches.py -q
"""

from __future__ import annotations

import pytest

from benchmark_torch import run


@pytest.mark.parametrize("launches,jobs,expected", [
    ({"warp_shift": 396, "stack_clip": 8}, 4, 99.0),   # one a warped light
    ({"warp_shift": 171, "gather_patches": 60}, 3, 57.0),
    ({"warp_shift": 0, "stack_clip": 8}, 4, 0.0),      # every warp took the gather
    ({"stack_clip": 8, "gather_patches": 9}, 4, None),  # a program without the kernel
])
def test_warp_launches_reader(launches, jobs, expected):
    value = run.load_metric("warp.launches").read({"jobs": jobs, "launches": launches})
    assert value == (None if expected is None else pytest.approx(expected))
