"""The port's replay backward (ops/replay.py) against the JAX package.

Float64 end to end, on scenes with perturbed (tie-free, strictly positive)
albedos carried across exactly with ``scene_from_arrays``:

* ``replay_param_grads`` against the JAX ``replay_param_grads`` on the
  same cotangent: the same bounce math and decisions, so the gradients
  agree to float64 reassociation, 1e-9 relative;
* against torch autograd of the port's own plain forward: 1e-9 relative;
* the documented zero-albedo deviation on ``simple``: finite gradients,
  exactly 0 on exactly-zero channels (``tests/test_replay.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.ops.replay import replay_param_grads as jax_replay_param_grads
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch.ops.replay import replay_param_grads
from cpu_path_tracing_tpu_torch.render import render_cells_range

torch.set_num_threads(1)

FIELDS = ("albedo", "emission", "background")
CAMERA = ("position", "look_at", "up", "aspect_ratio", "vertical_fov_radians", "aperture",
          "focus_distance", "origin_advance")
SPHERES = ("p0", "radius", "anchor_dir", "emission", "albedo", "material", "background")


def _carry(js):
    """The JAX scene's arrays, copied exactly into a port scene."""
    arrays = {f: np.asarray(getattr(js, f)) for f in SPHERES}
    arrays.update({f: np.asarray(getattr(js.camera, f)) for f in CAMERA})
    return tp.scene_from_arrays(arrays, ior=js.ior)


def _perturbed(name, cfg, seed=0):
    js = pt.get_scene(name, cfg.width, cfg.height, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        js,
        albedo=jnp.abs(js.albedo + rng.normal(0, 0.03, js.albedo.shape)) + 1e-3,
        emission=jnp.abs(js.emission + rng.normal(0, 0.03, js.emission.shape)))


def _assert_close(got, ref, rtol, what):
    for k in FIELDS:
        a, b = np.asarray(ref[k]), got[k].detach().numpy()
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * (np.abs(a).max() + 1e-300),
                                   err_msg=f"{what}/{k}")


# max_depth 14: past rr_depth (4), so the roulette term is exercised.
CFG = dict(width=10, height=8, spp=2, max_depth=14)


@pytest.mark.parametrize("name", ["box", "simple"])
def test_replay_matches_jax_replay(name):
    jcfg = pt.RenderConfig(**CFG)
    js = _perturbed(name, jcfg)
    ct = np.random.default_rng(1).normal(0, 1, (jcfg.num_cells, 3))
    ids = np.arange(jcfg.num_cells)
    ref = jax_replay_param_grads(js, jcfg, jnp.asarray(ids, jnp.int32), 0, 2, jnp.asarray(ct))
    got = replay_param_grads(_carry(js), tp.RenderConfig(**CFG), torch.from_numpy(ids), 0, 2,
                             torch.from_numpy(ct))
    assert all(got[k].dtype == torch.float64 for k in FIELDS)
    _assert_close(got, ref, 1e-9, name)


@pytest.mark.parametrize("name", ["box", "simple"])
def test_replay_matches_torch_autograd(name):
    cfg = tp.RenderConfig(**CFG)
    scene = _carry(_perturbed(name, cfg))
    ct = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (cfg.num_cells, 3)))
    ids = torch.arange(cfg.num_cells)
    params = {k: getattr(scene, k).clone().requires_grad_(True) for k in FIELDS}
    for k, v in params.items():
        setattr(scene, k, v)
    out = render_cells_range(scene, cfg, ids, 1, 2)
    ad = torch.autograd.grad((out * ct).sum(), [params[k] for k in FIELDS])
    got = replay_param_grads(scene, cfg, ids, 1, 2, ct)
    _assert_close(got, {k: g.numpy() for k, g in zip(FIELDS, ad)}, 1e-9, name)


def test_replay_zero_albedo_documented_deviation():
    """``simple`` has three spheres with an exactly-zero albedo channel: the
    guarded 1/albedo gives those channels a zero gradient (autograd gives
    the albedo-excluded product), and every gradient stays finite."""
    cfg = tp.RenderConfig(width=8, height=6, spp=1, max_depth=12)
    scene = tp.get_scene("simple", 8, 6, dtype=torch.float64)
    zero = scene.albedo == 0.0
    assert int(zero.any(dim=-1).sum()) == 3
    g = replay_param_grads(scene, cfg, torch.arange(cfg.num_cells), 0, 1,
                           torch.ones((cfg.num_cells, 3), dtype=torch.float64))
    assert all(bool(torch.isfinite(g[k]).all()) for k in FIELDS)
    assert bool((g["albedo"][zero] == 0.0).all())
    assert bool((g["albedo"][~zero] != 0.0).any())


def test_replay_auto_follows_the_scene_device(monkeypatch):
    """On the CPU the production replay is the batch replay; a CUDA scene
    the kernel takes (float32, uniform jitter, at most MAX_REPLAY_SPHERES
    spheres) goes to the kernel's gradient entry, never to the batch
    replay."""
    from cpu_path_tracing_tpu_torch.ops import replay as replay_ops
    from cpu_path_tracing_tpu_torch.ops.kernels import replay as rk

    cfg = tp.RenderConfig(width=8, height=6, spp=2, max_depth=10)
    scene = tp.get_scene("box", 8, 6, dtype=torch.float64)
    ids = torch.arange(cfg.num_cells)
    ct = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (cfg.num_cells, 3)))
    got = replay_ops.replay_param_grads_auto(scene, cfg, ids, 1, 2, ct)
    ref = replay_param_grads(scene, cfg, ids, 1, 2, ct)
    assert all(torch.equal(got[k], ref[k]) for k in FIELDS)

    calls = []
    monkeypatch.setattr(rk, "replay_param_grads_kernel", lambda *a: calls.append(a) or "kernel")
    monkeypatch.setattr(replay_ops, "replay_param_grads",
                        lambda *a: pytest.fail("the batch replay ran for a non-CPU scene"))
    on_card = type("OnCard", (), {"device": torch.device("cuda", 0), "dtype": torch.float32,
                                  "num_spheres": 8})()
    assert replay_ops.replay_param_grads_auto(on_card, cfg, ids, 1, 2, ct) == "kernel"
    assert len(calls) == 1 and calls[0][0] is on_card
