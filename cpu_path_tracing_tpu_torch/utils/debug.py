"""Numerical sanitizers: the NaN guard of ``--debug-nans``.

Counterpart of ``cpu_path_tracing_tpu/utils/debug.py``.  JAX traps the first
primitive that makes a NaN (``jax_debug_nans``); eager torch has no such
trap in the forward pass, and the CUDA kernels could not stop at one.  So
:func:`debug_context` turns on two checks instead, and restores both on
exit:

* ``torch.autograd.set_detect_anomaly(True)``: a backward function that
  returns NaN raises, naming the function;
* the guard (:func:`guard`), which ``render.render_cells_range`` and the
  inverse step's loss and gradients (``grad.make_accum_loss_grad``) call on
  what they return: a NaN raises ``FloatingPointError`` with the name of
  the output.

Neither changes the route: the kernels still run on the card, and the
guard reads their outputs after them.  ``disable_jit`` is kept for the JAX
signature and does nothing here: torch runs eagerly already.

:func:`assert_finite` and :func:`check_image` are explicit postconditions,
raising ``ValueError`` with the path of the first bad leaf.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

# True while a debug_context(nans=True) is open.
_GUARD = contextvars.ContextVar("pt_debug_guard", default=False)


@contextlib.contextmanager
def debug_context(nans: bool = True, disable_jit: bool = False):
    """Turn on the NaN guard and autograd's anomaly detection for the
    block; ``disable_jit`` does nothing (see the module docstring)."""
    del disable_jit
    anomaly = torch.is_anomaly_enabled()
    token = _GUARD.set(nans)
    torch.autograd.set_detect_anomaly(nans or anomaly)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        _GUARD.reset(token)


def guard_on() -> bool:
    return _GUARD.get()


def _leaves(tree, path=""):
    """(path, leaf) pairs of nested dicts, lists, tuples and modules
    (``Scene``, ``CameraConfig``: their buffers), paths written as
    ``jax.tree_util.keystr`` writes them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, torch.nn.Module):
        for k, v in tree.named_buffers():
            yield f"{path}.{k}", v
    else:
        yield path, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def guard(tree, name: str) -> None:
    """Inside a debug_context: raise ``FloatingPointError`` naming the
    output and leaf that holds a NaN.  Outside one it returns at once,
    reading nothing."""
    if not _GUARD.get():
        return
    for path, leaf in _leaves(tree):
        if not (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()):
            continue
        n_nan = int(torch.isnan(leaf).sum())
        if n_nan:
            raise FloatingPointError(f"{name}{path}: {n_nan} NaN of {leaf.numel()} values")


def assert_finite(tree, name: str = "tree") -> None:
    """Raise ValueError naming the first non-finite leaf (by its path)."""
    for path, leaf in _leaves(tree):
        arr = _host(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        if not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            raise ValueError(f"{name}{path}: {n_bad}/{arr.size} non-finite values")


def check_image(image) -> None:
    """Render postcondition: finite and non-negative linear radiance."""
    assert_finite(image, "image")
    arr = _host(image)
    if (arr < 0).any():
        raise ValueError(f"image has {(arr < 0).sum()} negative radiance values")
