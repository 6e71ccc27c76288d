"""Subscription-cube quantization, f64 positions to int64 cube labels.

A frozen copy of the broker's rule (upstream
worldql_server/src/subscriptions/cube_area.rs:23-44): cubes are labelled
by their max corner, sign-symmetric, exact 0.0 maps to ``+size``, exact
non-zero multiples label their own cube, and casts saturate like Rust's
``f64 as i64``.
"""

from __future__ import annotations

import numpy as np

_I64_MAX = 2**63 - 1
_I64_MIN = -(2**63)
_I64_MAX_F = float(_I64_MAX)
_I64_MIN_F = float(_I64_MIN)


def _sat_i64(x: np.ndarray) -> np.ndarray:
    safe = np.where(np.isfinite(x) & (np.abs(x) < _I64_MAX_F), x, 0.0)
    out = safe.astype(np.int64)
    out = np.where(x >= _I64_MAX_F, np.int64(_I64_MAX), out)
    out = np.where(x <= _I64_MIN_F, np.int64(_I64_MIN), out)
    return np.where(np.isnan(x), np.int64(0), out)


def cube_labels(positions: np.ndarray, size: int) -> np.ndarray:
    """[..., 3] float64 positions → int64 cube labels of the same shape."""
    c = np.asarray(positions, dtype=np.float64)
    size_f = float(size)
    abs_c = np.abs(c)
    sign = np.where(c < 0.0, -1, 1).astype(np.int64)
    with np.errstate(invalid="ignore"):
        exact = (np.fmod(abs_c, size_f) == 0.0) & (c != 0.0)
        rounded = np.ceil(abs_c / size_f) * size_f
        rounded = np.where(abs_c == 0.0, size_f, rounded)
        rounded_i = _sat_i64(rounded)
        bumped = np.minimum(rounded_i, _I64_MAX - size) + size
        out = np.where(rounded > c, rounded_i, bumped) * sign
        out = np.where(exact, _sat_i64(c), out)
        out = np.where(np.isposinf(c), np.int64(_I64_MAX), out)
        out = np.where(np.isneginf(c), np.int64(-_I64_MAX), out)
    return out
