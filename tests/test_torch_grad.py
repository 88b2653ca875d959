"""The port's inverse-rendering step (grad.py, cli invert) against the JAX package.

One ``make_accum_train_step`` step of the port (torch.optim.Adam) against
the JAX ``make_accum_train_step`` with ``optax.adam`` on the same float64
box scene, perturbed parameters and target, over more than one cell chunk:
the forward renders agree to float64 rounding and both backward passes are
the analytic replay, so the loss agrees to 1e-9 relative and the updated
parameters to 1e-7 absolute.  Adam's first step moves each parameter by
about lr * sign(gradient), so the gradient the step accumulates over the
chunks is also held to ``jax.value_and_grad`` of the JAX chunk loss,
summed over the chunks and divided by 3n: 1e-9 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu import grad as jgrad
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import cli, grad

torch.set_num_threads(1)

FIELDS = ("albedo", "emission")
W, H, SPP, DEPTH, CHUNK = 16, 12, 2, 12, 384  # 768 cells: two chunks


def _box_problem():
    """JAX and port configs, the float64 box in both, seeded parameter
    offsets and the JAX target."""
    jcfg = pt.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    tcfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    js = pt.get_scene("box", W, H, dtype=jnp.float64)
    ts = tp.get_scene("box", W, H, dtype=torch.float64)
    rng = np.random.default_rng(4)
    noise = {k: rng.normal(0, 0.03, getattr(js, k).shape) for k in FIELDS}
    return jcfg, tcfg, js, ts, noise, jgrad.render_target(js, jcfg, CHUNK)


def test_train_step_matches_jax():
    jcfg, tcfg, js, ts, noise, jtarget = _box_problem()
    target = grad.render_target(ts, tcfg, CHUNK)
    assert target.shape == (tcfg.num_cells, 3) and tcfg.num_cells > CHUNK
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), rtol=1e-9, atol=1e-12)

    jparams = {k: getattr(js, k) + noise[k] for k in FIELDS}
    opt = optax.adam(1e-2)
    jstep = jgrad.make_accum_train_step(js, jcfg, opt, cell_chunk=CHUNK)
    jnew, _, jloss = jstep(jparams, opt.init(jparams), jtarget)

    params = {k: getattr(ts, k) + torch.from_numpy(noise[k]) for k in FIELDS}
    step = grad.make_accum_train_step(ts, tcfg, 1e-2, cell_chunk=CHUNK)
    new, loss = step(params, torch.from_numpy(np.array(jtarget)))
    assert loss.dtype == torch.float64 and float(loss) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-9)
    for k in FIELDS:
        assert not new[k].requires_grad
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), rtol=0, atol=1e-7,
                                   err_msg=k)
        # Adam's first step moves every parameter with a nonzero gradient by ~lr.
        assert float((new[k] - params[k]).abs().max()) > 5e-3
    assert torch.equal(ts.albedo, tp.get_scene("box", W, H, dtype=torch.float64).albedo)


def test_accumulated_gradient_matches_jax():
    jcfg, tcfg, js, ts, noise, jtarget = _box_problem()
    render_mean = jgrad.make_diff_render(js, jcfg)

    @jax.jit
    def chunk_loss_grad(p, ids, tgt):
        return jax.value_and_grad(lambda q: jnp.sum((render_mean(q, ids) - tgt) ** 2))(p)

    jparams = {k: getattr(js, k) + noise[k] for k in FIELDS}
    n = jcfg.num_cells
    jloss, jgrads = 0.0, {k: 0.0 for k in FIELDS}
    for start in range(0, n, CHUNK):
        stop = min(start + CHUNK, n)
        sq, g = chunk_loss_grad(jparams, jnp.arange(start, stop, dtype=jnp.int32),
                                jtarget[start:stop])
        jloss = jloss + float(sq)
        jgrads = {k: jgrads[k] + np.asarray(g[k]) for k in FIELDS}

    loss_grad = grad.make_accum_loss_grad(ts, tcfg, cell_chunk=CHUNK)
    params = {k: getattr(ts, k) + torch.from_numpy(noise[k]) for k in FIELDS}
    loss, grads = loss_grad(params, torch.from_numpy(np.array(jtarget)))
    np.testing.assert_allclose(float(loss), jloss / (3 * n), rtol=1e-9)
    for k in FIELDS:
        ref = jgrads[k] / (3 * n)
        assert np.abs(ref).max() > 0, k
        assert grads[k].dtype == torch.float64 and not grads[k].requires_grad
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=k)


def test_non_replay_fields_raise():
    """A field outside OPTIMIZABLE raises; p0, outside the replay's fields,
    differentiates (the scan VJP) together with albedo."""
    cfg = tp.RenderConfig(width=8, height=6, spp=1, max_depth=4)
    scene = tp.get_scene("simple", 8, 6, dtype=torch.float64)
    render_sum = grad.make_diff_render_span(scene, cfg, 1)
    ids = torch.arange(cfg.num_cells)
    with pytest.raises(ValueError, match="cannot optimize"):
        render_sum({"ior": torch.tensor(2.0)}, ids)
    with pytest.raises(ValueError, match="cannot optimize"):
        grad.split_params(scene, ("ior",))
    params = {k: v.clone().requires_grad_(True)
              for k, v in grad.split_params(scene, ("albedo", "p0")).items()}
    g = torch.autograd.grad(render_sum(params, ids).sum(), tuple(params.values()))
    assert all(bool(torch.isfinite(x).all()) and float(x.abs().max()) > 0 for x in g)


@pytest.mark.parametrize("case", ["float64", "tent", "spheres"])
def test_cuda_scene_without_kernel_support_raises(monkeypatch, case):
    """A CUDA scene the replay kernel does not take (float64, tent jitter,
    more than MAX_REPLAY_SPHERES spheres) gets the plain replay on its own
    device, chosen before anything runs; the differentiable render builds
    for it.  A float32, uniform-jitter box takes the kernel.  (No card here:
    a CPU scene stands in, its device patched.)"""
    from cpu_path_tracing_tpu_torch.ops import replay as replay_ops
    from cpu_path_tracing_tpu_torch.ops.kernels import replay as rk

    monkeypatch.setattr(tp.Scene, "device", property(lambda self: torch.device("cuda", 0)))
    scene = tp.get_scene("random_spheres" if case == "spheres" else "box", 8, 6,
                         dtype=torch.float64 if case == "float64" else torch.float32)
    cfg = tp.RenderConfig(width=8, height=6, max_depth=8,
                          jitter="tent" if case == "tent" else "uniform")
    assert replay_ops.replay_route(scene, cfg) == "plain"
    assert replay_ops.replay_route(tp.get_scene("box", 8, 6), cfg.replace(jitter="uniform")) \
        == "kernel"
    grad.make_diff_render_span(scene, cfg, 1)
    calls = []
    monkeypatch.setattr(replay_ops, "replay_param_grads", lambda *a: calls.append(a) or "plain")
    monkeypatch.setattr(rk, "replay_param_grads_kernel",
                        lambda *a: pytest.fail("the replay kernel was asked for"))
    ids = torch.arange(cfg.num_cells)
    assert replay_ops.replay_param_grads_auto(scene, cfg, ids, 0, 1, None) == "plain"
    assert len(calls) == 1 and calls[0][0] is scene


def test_cli_invert_prints_json_lines(capsys):
    assert cli.main(["invert", "--scene", "box", "--width", "16", "--height", "12", "--spp", "2",
                     "--max-depth", "12", "--steps", "2", "--cell-chunk", "500", "--device",
                     "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in lines] == [0, 1]
    for r in lines:
        assert np.isfinite(r["loss"]) and r["loss"] > 0 and r["steps_per_s"] > 0
        assert set(r["mean_abs_err"]) == set(FIELDS)
    assert lines[1]["loss"] < lines[0]["loss"]
