"""The gates that hold one render to another.

The port's copy of the rules of the JAX package's on-chip gate
(``scripts/tpu_smoke.py``): the deviation of two renders is read element by
element on a scale that is absolute below 1 and relative above it, so that
dark cells and bright ones weigh alike.

* ``tier1``, the strict gate at low depth, where two implementations of one
  estimator take the same decisions on all but a few items;
* ``tier2``, the statistical gate at full depth, where an ulp that flips a
  discrete choice (Schlick, the nearest-hit tie, roulette) decorrelates a
  path for good: the deviation may not exceed an independent-seed render's
  by more than half, and every channel mean agrees within 1%;
* ``pin_gate``, the bar a float32 render of the port is held to against the
  JAX package's own (XLA on the CPU rounds its ``rsqrt``, ``sin`` and
  ``cos`` otherwise than the port, so a few items flip).

Every gate returns a record of plain floats with ``ok``.  ``axis`` names the
channel axis: -1 for [cells, 3] sums and images, 0 for a kernel's [3, items]
output.  Inputs are numpy arrays or tensors (read on the host).
"""

from __future__ import annotations

import numpy as np
import torch

TIER1_P999 = 1e-5  # p99.9 of the items' worst channel
TIER1_FLIPPED = 1e-3  # share of items above 1e-3
TIER2_FACTOR, TIER2_SLACK = 1.5, 1e-6  # mean deviation <= factor * yardstick + slack
CHANNEL_TOL = 0.01  # every channel mean within 1%
PIN_DEV, PIN_SHARE = 1e-4, 0.01  # at most 1% of pixels above 1e-4


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scale_aware(a, b):
    """Elementwise ``|a-b| / max(|a|, |b|, 1)``: a tensor for tensors, else
    a numpy array."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return (a - b).abs() / torch.clamp(torch.maximum(a.abs(), b.abs()), min=1.0)
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)


def _worst_channel(got, ref, axis: int) -> np.ndarray:
    return _host(scale_aware(got, ref)).max(axis=axis)


def _channel_means(x, axis: int) -> np.ndarray:
    """Each channel's mean over every other axis, in float64."""
    x = np.moveaxis(_host(x), axis, -1)
    return x.reshape(-1, x.shape[-1]).mean(axis=0, dtype=np.float64)


def _ratios(got, ref, axis: int) -> np.ndarray:
    return _channel_means(got, axis) / np.maximum(_channel_means(ref, axis), 1e-12)


def tier1(got, ref, axis: int = -1) -> dict:
    """The strict gate: each item's worst channel, p99.9 < 1e-5 and fewer
    than 0.1% of items above 1e-3; the share of elements exactly equal
    beside them."""
    dev = _worst_channel(got, ref, axis)
    rec = {"p999": float(np.quantile(dev, 0.999)),
           "frac_above_1e-3": float(np.mean(dev > 1e-3)),
           "exact_frac": float(np.mean(_host(got) == _host(ref)))}
    rec["ok"] = rec["p999"] < TIER1_P999 and rec["frac_above_1e-3"] < TIER1_FLIPPED
    return rec


def tier2(got, ref, alt, axis: int = -1) -> dict:
    """The statistical gate: the mean deviation of ``got`` from ``ref`` at
    most 1.5x that of ``alt`` (an independent-seed render of ``ref``'s
    estimator, the Monte-Carlo yardstick) plus 1e-6, and every channel
    mean of ``got`` within 1% of ``ref``'s."""
    ratios = _ratios(got, ref, axis)
    rec = {"mean_dev": float(_host(scale_aware(got, ref)).mean()),
           "seed_yardstick": float(_host(scale_aware(alt, ref)).mean()),
           "channel_ratios": [float(r) for r in ratios]}
    rec["ok"] = (rec["mean_dev"] <= TIER2_FACTOR * rec["seed_yardstick"] + TIER2_SLACK
                 and bool(np.all(np.abs(ratios - 1.0) < CHANNEL_TOL)))
    return rec


def pin_gate(got, ref, axis: int = -1, mean_tol: float = CHANNEL_TOL) -> dict:
    """The cross-package bar: at most 1% of pixels (cells) whose worst
    channel is above 1e-4, and every channel mean within ``mean_tol``."""
    dev = _worst_channel(got, ref, axis)
    ratios = _ratios(got, ref, axis)
    rec = {"frac_above_1e-4": float(np.mean(dev > PIN_DEV)), "max_dev": float(dev.max()),
           "channel_ratios": [float(r) for r in ratios]}
    rec["ok"] = (rec["frac_above_1e-4"] <= PIN_SHARE
                 and bool(np.all(np.abs(ratios - 1.0) < mean_tol)))
    return rec
