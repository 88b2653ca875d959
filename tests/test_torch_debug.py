"""The port's NaN guard and postconditions (``utils/debug.py``), case for
case with ``tests/test_debug.py``.

Torch has no forward NaN trap like ``jax_debug_nans``: inside
``debug_context`` a render's sums and an inverse step's loss and gradients
are checked (``FloatingPointError`` naming the output) and autograd's
anomaly detection is on.  ``assert_finite`` names the bad leaf by the path
``jax.tree_util.keystr`` writes, with the JAX message.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_path_tracing_tpu.utils import debug as jax_debug
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import grad
from cpu_path_tracing_tpu_torch.render import render_cells_range, render_image
from cpu_path_tracing_tpu_torch.utils.debug import (
    assert_finite,
    check_image,
    debug_context,
    guard_on,
)

torch.set_num_threads(1)

CFG = tp.RenderConfig(width=8, height=6, spp=1, max_depth=8)


def _nan_emission_scene():
    scene = tp.get_scene("box", CFG.width, CFG.height)
    scene.emission[7] = float("nan")  # the light
    return scene


def test_debug_context_catches_nan():
    scene = _nan_emission_scene()
    ids = torch.arange(CFG.num_cells)
    assert torch.isnan(render_cells_range(scene, CFG, ids, 0, 1)).any()  # unguarded: no check
    with pytest.raises(FloatingPointError, match="render_cells_range"):
        with debug_context(nans=True):
            render_cells_range(scene, CFG, ids, 0, 1)
    # The backward: anomaly detection names the function that returned NaN.
    x = torch.tensor([-1.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with debug_context(nans=True):
            torch.sqrt(x).sum().backward()


def test_debug_context_restores_flags():
    before = torch.is_anomaly_enabled()
    with debug_context(nans=True):
        assert torch.is_anomaly_enabled() and guard_on()
    assert torch.is_anomaly_enabled() == before and not guard_on()
    with pytest.raises(FloatingPointError):
        with debug_context(nans=True):
            render_cells_range(_nan_emission_scene(), CFG, torch.arange(CFG.num_cells), 0, 1)
    assert torch.is_anomaly_enabled() == before and not guard_on()


def test_render_is_nan_free_under_sanitizer():
    """The production render and an inverse step pass the guard end to end."""
    scene = tp.get_scene("box_mirror", 8, 6)
    with debug_context(nans=True):
        img = render_image(scene, CFG)
        box = tp.get_scene("box", 8, 6)
        step = grad.make_accum_train_step(box, CFG, 1e-2)
        params = {k: v + 0.02 for k, v in grad.split_params(box, ("albedo", "emission")).items()}
        params, loss = step(params, grad.render_target(box, CFG))
    check_image(img)
    assert np.isfinite(float(loss))
    # A NaN that reaches the step's loss and gradients is named there.
    loss_grad = grad.make_accum_loss_grad(box, CFG)
    bad = {"albedo": params["albedo"], "emission": params["emission"].clone()}
    bad["emission"][7] = float("nan")
    with pytest.raises(FloatingPointError):
        with debug_context(nans=True):
            loss_grad(bad, grad.render_target(box, CFG))


def test_assert_finite_names_leaf():
    tree = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, np.nan])}}
    with pytest.raises(ValueError, match=r"\['b'\]\['c'\]") as ours:
        assert_finite(tree, "tree")
    jtree = {"a": jnp.ones(3), "b": {"c": jnp.asarray([1.0, np.nan])}}
    with pytest.raises(ValueError) as theirs:
        jax_debug.assert_finite(jtree, "tree")
    assert str(ours.value) == str(theirs.value)
    assert_finite({"a": torch.ones(3)})  # clean tree passes
    with pytest.raises(ValueError, match=r"\.emission"):
        assert_finite(_nan_emission_scene(), "scene")


def test_check_image_rejects_negative():
    with pytest.raises(ValueError, match="negative"):
        check_image(torch.tensor([[-1.0, 0.0, 0.0]]))
    with pytest.raises(ValueError, match="non-finite"):
        check_image(torch.tensor([[np.inf, 0.0, 0.0]]))
