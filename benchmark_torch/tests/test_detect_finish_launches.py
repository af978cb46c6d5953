"""CPU test of the detect.finish_launches reader (benchmark_torch/metrics/)
on hand-made records of a traced run.

    python -m pytest benchmark_torch/tests/test_detect_finish_launches.py -q
"""

from __future__ import annotations

import pytest

from benchmark_torch import run


@pytest.mark.parametrize("launches,jobs,expected", [
    ({"detect_finish": 404, "gather_patches": 404}, 4, 101.0),  # 100 lights and the stack
    ({"detect_finish": 189, "stack_clip": 9}, 3, 63.0),          # three channels of 20
    ({"detect_finish": 33, "warp_shift": 30}, 3, 11.0),
    ({"detect_finish": 0, "stack_clip": 8}, 4, 0.0),
    ({"stack_clip": 8, "gather_patches": 9}, 4, None),  # a program without the kernel
])
def test_detect_finish_launches_reader(launches, jobs, expected):
    value = run.load_metric("detect.finish_launches").read({"jobs": jobs, "launches": launches})
    assert value == (None if expected is None else pytest.approx(expected))
