"""The geometry and camera backward of the port against the JAX package.

Float64 on the CPU at the JAX tests' size (``tests/test_grad.py``: 12x8,
2 spp, max_depth 8).  The JAX side runs as its own tests run it:
``jax.grad`` of ``cell_loss`` through the scan loop, and its
``make_accum_train_step`` with ``optax.adam``.  The port's gradients of
every field of ``OPTIMIZABLE`` (the camera's eight leaves each) agree to
1e-9 relative, Adam's parameters after two steps to 1e-9 absolute, and the
port's decoupled span (forward route, chunked backward) with direct
autograd of its scan loop to 1e-12 relative.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu import grad as jgrad
from cpu_path_tracing_tpu.ops.intersect import intersect_scene as jax_intersect
from cpu_path_tracing_tpu.render import render_cells as jax_render_cells
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import cli, grad
from cpu_path_tracing_tpu_torch.models.camera import FIELDS as CAMERA_FIELDS
from cpu_path_tracing_tpu_torch.ops import integrator as tint
from cpu_path_tracing_tpu_torch.ops.intersect import intersect_scene
from cpu_path_tracing_tpu_torch.render import camera_rays, render_cells_range

torch.set_num_threads(1)

W, H, SPP, DEPTH = 12, 8, 2, 8
SPHERE_ARRAYS = ("p0", "radius", "anchor_dir", "emission", "albedo", "material", "background")


def _jax_arrays(params):
    """A JAX params dict as NumPy, the camera as a dict of its eight fields."""
    return {k: ({f: np.asarray(getattr(v, f)) for f in CAMERA_FIELDS} if k == "camera"
                else np.asarray(v)) for k, v in params.items()}


def _carry(js):
    """The JAX scene's arrays, copied exactly into a port scene."""
    arrays = {f: np.asarray(getattr(js, f)) for f in SPHERE_ARRAYS}
    arrays["camera"] = _jax_arrays({"camera": js.camera})["camera"]
    return tp.scene_from_arrays(arrays, ior=js.ior)


def _grads(loss_of, params):
    """Autograd of ``loss_of(params)`` with respect to every leaf, as a
    {leaf name: array} dict (``grad.flatten_params`` names)."""
    names, values = grad.flatten_params(params)
    leaves = [v.detach().clone().requires_grad_(True) for v in values]
    g = torch.autograd.grad(loss_of(grad.unflatten_params(names, leaves)), leaves)
    return dict(zip(names, (x.numpy() for x in g)))


def _jax_leaves(g):
    """A JAX params or gradient pytree as {leaf name: array}, with the
    port's names and order (``grad.flatten_params``)."""
    out = {}
    for k in sorted(g):
        if k == "camera":
            out.update({f"camera.{f}": np.asarray(getattr(g[k], f)) for f in CAMERA_FIELDS})
        else:
            out[k] = np.asarray(g[k])
    return out


@pytest.fixture(scope="module")
def simple():
    """The open scene with a 0.9x target (nonzero geometry gradients, as in
    tests/test_grad.py _setup_open) and the JAX gradients of all six fields."""
    jcfg = pt.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH, loop="scan")
    js = pt.get_scene("simple", W, H, dtype=jnp.float64)
    ids = jnp.arange(jcfg.num_cells, dtype=jnp.int32)
    target = jax_render_cells(js, jcfg, ids) * 0.9
    jparams = jgrad.split_params(js, jgrad.OPTIMIZABLE)
    jg = jax.grad(jgrad.cell_loss)(jparams, js, jcfg, ids, target)
    tcfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    return dict(js=js, ts=_carry(js), tcfg=tcfg, ids=torch.arange(tcfg.num_cells),
                target=torch.from_numpy(np.array(target)), jgrads=_jax_leaves(jg))


def test_all_fields_match_jax_grad(simple):
    """Every field of OPTIMIZABLE, the camera's eight leaves each: nonzero
    and within 1e-9 relative of jax.grad (atol 1e-9 of the field's largest
    magnitude).  ``origin_advance`` moves each camera ray's origin along its
    own direction, which leaves the path unchanged: its gradient is zero up
    to rounding in both packages."""
    ts, tcfg = simple["ts"], simple["tcfg"]
    got = _grads(lambda p: grad.cell_loss(p, ts, tcfg, simple["ids"], simple["target"]),
                 grad.split_params(ts, grad.OPTIMIZABLE))
    ref = simple["jgrads"]
    assert set(got) == set(ref) and len(got) == 5 + len(CAMERA_FIELDS)
    for field in grad.OPTIMIZABLE:
        names = [n for n in ref if n.split(".")[0] == field]
        scale = max(float(np.abs(ref[n]).max()) for n in names)
        assert scale > 0, field
        for n in names:
            np.testing.assert_allclose(got[n], ref[n], rtol=1e-9, atol=1e-9 * scale, err_msg=n)
            if n != "camera.origin_advance":
                assert np.abs(got[n]).max() > 0, n
    assert abs(float(got["camera.origin_advance"])) < 1e-12 * scale


def test_box_geometry_gradients_are_zero():
    """In the closed box no path reaches the background, so the detached
    estimator's p0 and radius gradients are exactly zero (visibility edges
    are not sampled); albedo's are not."""
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    ts = tp.get_scene("box", W, H, dtype=torch.float64)
    ids = torch.arange(cfg.num_cells)
    target = grad.render_target(ts, cfg) * 0.9
    g = _grads(lambda p: grad.cell_loss(p, ts, cfg, ids, target),
               grad.split_params(ts, ("p0", "radius", "albedo")))
    assert np.abs(g["p0"]).max() == 0.0 and np.abs(g["radius"]).max() == 0.0
    assert np.abs(g["albedo"]).max() > 0.0


@pytest.mark.parametrize("sample_chunk", [1, 2])
def test_decoupled_span_matches_direct_autograd(simple, sample_chunk):
    """``make_diff_render`` (the forward route, then the backward recomputed
    ``sample_chunk`` samples at a time on the checkpointed batch route)
    gives direct autograd's loss bitwise and its gradients within 1e-12
    relative (the chunks add in another order).  Direct autograd of the scan
    loop is bitwise the same with and without checkpointed bounces."""
    ts, tcfg, ids = simple["ts"], simple["tcfg"], simple["ids"]
    target = torch.full((tcfg.num_cells, 3), 0.5, dtype=torch.float64)
    params = grad.split_params(ts, grad.OPTIMIZABLE)
    render_mean = grad.make_diff_render(ts, tcfg, sample_chunk=sample_chunk)
    bwd_cfg = render_mean.span.bwd_cfg
    assert bwd_cfg.remat and bwd_cfg.integrator == "batch"

    def decoupled(p):
        return ((render_mean(p, ids) - target) ** 2).mean()

    def direct(p, remat):
        out = render_cells_range(grad.merge_params(ts, p),
                                 tcfg.replace(loop="scan", integrator="batch", remat=remat),
                                 ids, 0, SPP) / SPP
        return ((out - target) ** 2).mean()

    with torch.no_grad():
        assert torch.equal(decoupled(params), direct(params, False))
    got = _grads(decoupled, params)
    ref = _grads(lambda p: direct(p, False), params)
    remat = _grads(lambda p: direct(p, True), params)
    for n in ref:
        np.testing.assert_array_equal(remat[n], ref[n], err_msg=n)
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-12,
                                   atol=1e-12 * np.abs(ref[n]).max(), err_msg=n)


def test_compaction_matches_plain_scan():
    """Live-ray compaction (``radiance_compact`` on a pilot-tuned schedule)
    gives the plain scan's radiance and gradients within 1e-12, and drops no
    live ray (``backward_drop_count`` is 0 by construction)."""
    cfg = tp.RenderConfig(width=W, height=H, spp=1, max_depth=24)
    ts = tp.get_scene("box", W, H, dtype=torch.float64)
    sched = grad.tune_backward_schedule(ts, cfg, probe_cells=256)
    assert sched is not None and len(sched) >= 2 and sum(sched) == cfg.max_depth
    keys, o, d = camera_rays(ts, cfg, torch.arange(cfg.num_cells), 0, torch.float64)
    kw = dict(max_depth=cfg.max_depth, rr_depth=cfg.rr_depth)
    ref = tint.radiance(ts, o, d, keys, loop="scan", **kw)
    for loop in ("scan", "while"):
        out = tint.radiance_compact(ts, o, d, keys, schedule=sched, loop=loop, **kw)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    ids = torch.arange(cfg.num_cells)
    params = grad.split_params(ts, ("p0", "albedo"))

    def total(p, schedule):
        c = cfg.replace(loop="scan", integrator="batch", compact_schedule=schedule)
        return render_cells_range(grad.merge_params(ts, p), c, ids, 0, 1).sum()

    g0, g1 = _grads(lambda p: total(p, None), params), _grads(lambda p: total(p, sched), params)
    for n in g0:
        np.testing.assert_allclose(g1[n], g0[n], rtol=1e-12, atol=1e-12, err_msg=n)
    assert grad.backward_drop_count(ts, cfg.replace(compact_schedule=sched), 96) == 0


def test_replay_step_runs_no_pilot(monkeypatch):
    """The scan VJP's schedule is tuned on its first use: a step of replay
    fields never runs the pilot, and its drop check is 0; a p0 step tunes
    once and its drop check is 0 (the compaction is exact)."""
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return tune(*a, **kw)

    tune = grad.tune_backward_schedule
    monkeypatch.setattr(grad, "tune_backward_schedule", counted)
    cfg = tp.RenderConfig(width=W, height=H, spp=1, max_depth=16)
    ts = tp.get_scene("box", W, H, dtype=torch.float64)
    target = grad.render_target(ts, cfg) * 0.9
    for fields, tuned in ((("albedo", "emission"), 0), (("p0", "albedo"), 1)):
        step = grad.make_accum_train_step(ts, cfg, 1e-2)
        assert step.drop_check() == 0
        for _ in range(2):
            params, loss = step(grad.split_params(ts, fields), target)
            assert np.isfinite(float(loss)) and step.drop_check(params) == 0
        assert len(calls) == tuned
    assert not hasattr(grad.make_accum_train_step(ts, cfg, 1e-2, compact=False), "drop_check")


def test_nearest_hit_tie_splits_the_gradient_as_jax():
    """Two identical spheres (3 and 5): every hit goes to sphere 3, and the
    gradient of t with respect to p0 and radius splits evenly between them,
    as ``jnp.min``'s does (``torch.min(dim)`` gave all of it to sphere 3)."""
    js = pt.get_scene("simple", 16, 12, dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(js, f)) for f in SPHERE_ARRAYS}
    for f in SPHERE_ARRAYS[:-1]:
        arrays[f] = np.concatenate([arrays[f], arrays[f][3:4]])
    rng = np.random.default_rng(3)
    target = arrays["p0"][3] - arrays["radius"][3] * arrays["anchor_dir"][3]
    o = np.tile(np.asarray(js.camera.position), (256, 1))
    d = target + rng.normal(0, 0.1, (256, 3)) - o
    jtie = dataclasses.replace(js, **{f: jnp.asarray(arrays[f]) for f in SPHERE_ARRAYS})

    def jloss(p0, radius):
        t, _, hit = jax_intersect(dataclasses.replace(jtie, p0=p0, radius=radius),
                                  jnp.asarray(o), jnp.asarray(d))
        return jnp.sum(jnp.where(hit, t, 0.0))

    ref = jax.grad(jloss, argnums=(0, 1))(jtie.p0, jtie.radius)
    arrays["camera"] = _jax_arrays({"camera": js.camera})["camera"]
    ts = tp.scene_from_arrays(arrays, ior=js.ior)
    p0, radius = (getattr(ts, f).clone().requires_grad_(True) for f in ("p0", "radius"))
    ts.p0, ts.radius = p0, radius
    t, hid, hit = intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d))
    assert int((hit & (hid == 3)).sum()) > 100 and not bool((hid == 5).any())
    got = torch.autograd.grad(torch.where(hit, t, 0.0).sum(), (p0, radius))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(r[5]).max() > 0
        np.testing.assert_allclose(g[5].numpy(), g[3].numpy(), rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-9, atol=1e-12)


def test_adam_steps_match_optax():
    """Two ``make_accum_train_step`` steps on p0, radius and the camera (all
    eight leaves stepped) over two cell chunks: the loss each step within
    1e-9 relative and the parameters within 1e-9 of the JAX step with
    ``optax.adam``."""
    fields, chunk, lr = ("p0", "radius", "camera"), 96, 1e-2
    jcfg = pt.RenderConfig(width=8, height=6, spp=SPP, max_depth=DEPTH)
    js = pt.get_scene("simple", 8, 6, dtype=jnp.float64)
    jtarget = jgrad.render_target(js, jcfg, chunk) * 0.9
    rng = np.random.default_rng(5)
    jparams = jax.tree.map(lambda x: x + rng.normal(0, 0.01, x.shape),
                           jgrad.split_params(js, fields))
    opt = optax.adam(lr)
    jstep = jgrad.make_accum_train_step(js, jcfg, opt, cell_chunk=chunk)
    state, jp, jlosses = opt.init(jparams), jparams, []
    for _ in range(2):
        jp, state, jloss = jstep(jp, state, jtarget)
        jlosses.append(float(jloss))

    tcfg = tp.RenderConfig(width=8, height=6, spp=SPP, max_depth=DEPTH)
    step = grad.make_accum_train_step(_carry(js), tcfg, lr, cell_chunk=chunk)
    p = tp.params_from_arrays(_jax_arrays(jparams))
    target = torch.from_numpy(np.array(jtarget))
    for jl in jlosses:
        p, loss = step(p, target)
        np.testing.assert_allclose(float(loss), jl, rtol=1e-9)
    got, ref = dict(zip(*grad.flatten_params(p))), _jax_leaves(jp)
    start = _jax_leaves(jparams)
    for n in ref:
        np.testing.assert_allclose(got[n].numpy(), ref[n], rtol=0, atol=1e-9, err_msg=n)
    moved = [n for n in ref if np.abs(ref[n] - start[n]).max() > 1e-3]
    assert {"p0", "radius", "camera.position", "camera.look_at"} <= set(moved)


def test_cli_invert_geometry_and_camera(capsys):
    """``cli invert --fields p0,radius,camera --device cpu``: one JSON line a
    step, the camera's errors field by field, and the start equal to the JAX
    CLI's perturbation (jax.tree.map over the params: keys sorted, then the
    camera's data fields in order) for the same seed."""
    fields, seed, perturb = ("p0", "radius", "camera"), 3, 0.05
    assert cli.main(["invert", "--scene", "simple", "--width", "8", "--height", "6", "--spp",
                     "1", "--max-depth", "6", "--steps", "2", "--cell-chunk", "100", "--seed",
                     str(seed), "--fields", ",".join(fields), "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in lines] == [0, 1]
    for r in lines:
        assert np.isfinite(r["loss"]) and r["loss"] > 0 and r["steps_per_s"] > 0
        assert set(r["mean_abs_err"]) == set(fields)
        assert set(r["mean_abs_err"]["camera"]) == set(CAMERA_FIELDS)

    got = cli.perturbed_params(grad.split_params(tp.get_scene("simple", 8, 6), fields), seed,
                               perturb)
    rng = np.random.default_rng(seed)
    ref = jax.tree.map(lambda x: x + jnp.asarray(rng.normal(0, perturb, x.shape), x.dtype),
                       jgrad.split_params(pt.get_scene("simple", 8, 6, dtype=jnp.float32),
                                          fields))
    got, ref = dict(zip(*grad.flatten_params(got))), _jax_leaves(ref)
    assert list(got) == list(ref)
    for n in ref:
        assert got[n].dtype == torch.float32
        np.testing.assert_array_equal(got[n].numpy(), ref[n], err_msg=n)


def test_train_step_matches_jax_train_step():
    """``train_step`` with ``torch.optim.Adam`` over the leaves of p0 and the
    camera, two steps on the whole image, against the JAX ``train_step``
    with ``optax.adam``: each step's loss within 1e-9 relative, the
    parameters within 1e-9."""
    fields, lr = ("camera", "p0"), 1e-2
    jcfg = pt.RenderConfig(width=8, height=6, spp=1, max_depth=6, loop="scan")
    js = pt.get_scene("simple", 8, 6, dtype=jnp.float64)
    ids = jnp.arange(jcfg.num_cells, dtype=jnp.int32)
    target = jax_render_cells(js, jcfg, ids) * 0.9
    jparams = jgrad.split_params(js, fields)
    opt = optax.adam(lr)
    state, jlosses = opt.init(jparams), []
    for _ in range(2):
        jparams, state, jloss = jgrad.train_step(jparams, state, js, jcfg, opt, ids, target)
        jlosses.append(float(jloss))

    ts = _carry(js)
    names, values = grad.flatten_params(grad.split_params(ts, fields))
    leaves = [v.clone().requires_grad_(True) for v in values]
    params = grad.unflatten_params(names, leaves)
    adam = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    cfg = tp.RenderConfig(width=8, height=6, spp=1, max_depth=6)
    for jl in jlosses:
        params, loss = grad.train_step(params, adam, ts, cfg, torch.arange(cfg.num_cells),
                                       torch.from_numpy(np.array(target)))
        np.testing.assert_allclose(float(loss), jl, rtol=1e-9)
    got = dict(zip(*grad.flatten_params(params)))
    for n, r in _jax_leaves(jparams).items():
        np.testing.assert_allclose(got[n].detach().numpy(), r, rtol=0, atol=1e-9, err_msg=n)


def test_float32_camera_steps_stay_finite(capsys):
    """Float32 rays that leave a refraction or graze a sphere exactly tangent
    make sqrt's argument 0 (``ops/materials``'s kk, ``ops/intersect``'s
    disc); unguarded, its infinite derivative times a zero cotangent turned
    every parameter NaN after the first step of this run."""
    assert cli.main(["invert", "--scene", "simple", "--width", "64", "--height", "48", "--spp",
                     "1", "--fields", "p0,radius,camera", "--steps", "2", "--device",
                     "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    errs = [e for r in lines for k, v in r["mean_abs_err"].items()
            for e in (v.values() if k == "camera" else [v])]
    assert len(lines) == 2 and len(errs) == 2 * 10 and np.all(np.isfinite(errs))
