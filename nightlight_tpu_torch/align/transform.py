"""2D affine transforms as 6-vectors [a, b, c, d, e, f]:
x' = a*x + b*y + c ; y' = d*x + e*y + f.

Mirror of nightlight_tpu/align/transform.py (reference: internal/star/coord.go).
"""

from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    """Identity transform (coord.go:111-113)."""
    return np.array([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], np.float32)


def invert(t: np.ndarray) -> np.ndarray:
    """Closed-form inverse (coord.go:159-201). Raises on singular."""
    a, b, c, d, e, f = (float(v) for v in t)
    eps = b * d - a * e
    if abs(eps) < 1e-8:
        raise ValueError(f"Matrix has no inverse, epsilon={eps:g}")
    return np.array(
        [
            -e / eps, b / eps, (c * e - b * f) / eps,
            -d / (a * e - b * d), a / (a * e - b * d), (c * d - a * f) / (a * e - b * d),
        ],
        np.float32,
    )


def to_string(t) -> str:
    """Log formatting matching coord.go:73-76."""
    a, b, c, d, e, f = (float(v) for v in t)
    return f"x'={a:.5f}x {b:+.5f}y {c:+.2f}, y'={d:.5f}x {e:+.5f}y {f:+.2f}"
