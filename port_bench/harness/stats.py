"""The window's statistics and the run's seeds."""

from __future__ import annotations

import math

import numpy as np

MASK64 = (1 << 64) - 1


def derive(seed: int, *path: int) -> int:
    """A 63-bit seed drawn from the run's ``--seed`` and a path of whole
    numbers (what it is for, an index): the same path gives the same seed."""
    words = np.random.SeedSequence([int(seed) & MASK64, *path]).generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & ((1 << 63) - 1)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks of the sorted values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def per_unit_ms(window_s: float, completed: int) -> float:
    """The whole window over the units it completed, in ms."""
    if completed <= 0:
        raise ValueError("the window completed nothing")
    return 1e3 * window_s / completed
