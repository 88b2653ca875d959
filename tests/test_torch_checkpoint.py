"""The port's progressive checkpoints and inverse-run checkpoints
(``cpu_path_tracing_tpu_torch/utils/checkpoint.py``), case for case with
``tests/test_checkpoint.py``, and against the JAX package.

* A resumed progressive render equals the uninterrupted one bitwise, and a
  progressive render equals the single-pass render up to the association
  of the per-batch sums (float32 relative 1e-6).
* Against the JAX ``render_progressive`` on the same (scene, config, seed):
  float64 scale-aware deviation < 1e-12; float32 at most 0.1% of pixels
  above 1e-5 scale-aware (an ulp of a transcendental can flip a discrete
  decision, ROADMAP.md Hazards).
* The render fingerprint equals the JAX ``_fingerprint`` for every scene in
  both dtypes, and ``invert_fingerprint`` equals JAX's: a checkpoint is
  keyed the same in both packages.
* A resumed inverse run continues the uninterrupted one bitwise: params and
  Adam's counter and moments, through a new step function.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.utils import checkpoint as jax_ck
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import grad
from cpu_path_tracing_tpu_torch.render import render_image
from cpu_path_tracing_tpu_torch.utils.checkpoint import (
    InvertState,
    ProgressiveState,
    _fingerprint,
    invert_fingerprint,
    load_or_init_invert,
    render_progressive,
)
from cpu_path_tracing_tpu_torch.utils.parity import scale_aware

torch.set_num_threads(1)

CFG = tp.RenderConfig(width=16, height=12, spp=4, max_depth=12)
JCFG = pt.RenderConfig(width=16, height=12, spp=4, max_depth=12, integrator="wavefront")


def test_resume_is_bit_exact(tmp_path):
    scene = tp.get_scene("box", CFG.width, CFG.height)
    full = render_progressive(scene, CFG)

    ck = str(tmp_path / "ck.npz")
    render_progressive(scene, CFG.replace(spp=2), ck, flush_every=1)  # "interrupted"
    assert ProgressiveState.load(ck).spp_done == 2
    resumed = render_progressive(scene, CFG, ck, flush_every=1)
    assert ProgressiveState.load(ck).spp_done == 4
    assert torch.equal(resumed, render_progressive(scene, CFG, flush_every=1))
    # Against one pass: the same samples, the batch sums associated otherwise.
    torch.testing.assert_close(resumed, full, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(full, render_image(scene, CFG), rtol=0, atol=0)


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32), (jnp.float64, torch.float64)],
                         ids=["f32", "f64"])
def test_progressive_matches_jax(dtypes):
    jd, td = dtypes
    ref = np.asarray(jax_ck.render_progressive(pt.get_scene("box_mirror", 16, 12, dtype=jd), JCFG,
                                               flush_every=1))
    got = render_progressive(tp.get_scene("box_mirror", 16, 12, dtype=td), CFG,
                             flush_every=1).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    dev = scale_aware(got, ref)
    if td == torch.float64:
        assert float(dev.max()) < 1e-12
    else:
        assert float(np.mean(dev > 1e-5)) <= 1e-3


def test_fingerprint_mismatch_rejected(tmp_path):
    scene = tp.get_scene("box", CFG.width, CFG.height)
    ck = str(tmp_path / "ck.npz")
    render_progressive(scene, CFG.replace(spp=1), ck, flush_every=1)
    other = tp.get_scene("simple", CFG.width, CFG.height)
    with pytest.raises(ValueError, match="different"):
        render_progressive(other, CFG, ck)
    with pytest.raises(ValueError, match="different"):
        render_progressive(scene, CFG.replace(seed=7), ck)


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32), (jnp.float64, torch.float64)],
                         ids=["f32", "f64"])
def test_fingerprint_matches_jax(dtypes):
    jd, td = dtypes
    for name in pt.scene_names():
        js, ts = pt.get_scene(name, 16, 12, dtype=jd), tp.get_scene(name, 16, 12, dtype=td)
        assert _fingerprint(ts, CFG) == jax_ck._fingerprint(js, JCFG), name
        args = (("emission", "albedo"), 1e-2, 1 << 17, 1)
        assert invert_fingerprint(ts, CFG, *args) == jax_ck.invert_fingerprint(js, JCFG, *args)


@pytest.mark.parametrize("mesh_shape", [(4, 2), None], ids=["4x2", "one_device"])
def test_invert_fingerprint_hashes_the_mesh_as_jax(mesh_shape):
    js, ts = pt.get_scene("box", 16, 12), tp.get_scene("box", 16, 12)
    args = (("albedo", "emission"), 1e-2, 1 << 17, 1)
    got = invert_fingerprint(ts, CFG, *args, mesh_shape=mesh_shape)
    assert got == jax_ck.invert_fingerprint(js, JCFG, *args, mesh_shape=mesh_shape)
    assert (got == invert_fingerprint(ts, CFG, *args)) == (mesh_shape is None)


def test_one_device_checkpoint_is_refused_under_a_mesh(tmp_path):
    """A checkpoint of ``cli invert`` on one device does not resume under
    ``--mesh 2x2``: the shards add the sums in another order."""
    from cpu_path_tracing_tpu_torch import cli

    ck = str(tmp_path / "inv.npz")
    argv = ["invert", "--scene", "box", "--width", "8", "--height", "6", "--spp", "2",
            "--max-depth", "6", "--device", "cpu", "--checkpoint", ck]
    assert cli.main([*argv, "--steps", "1"]) == 0
    with pytest.raises(ValueError, match="different"):
        cli.main([*argv, "--steps", "2", "--mesh", "2x2"])
    assert cli.main([*argv, "--steps", "2"]) == 0  # the same command without it resumes


def test_progress_callback(tmp_path):
    scene = tp.get_scene("box", CFG.width, CFG.height)
    seen = []
    render_progressive(scene, CFG, progress=lambda d, t: seen.append((d, t)), flush_every=2)
    assert seen == [(2, 4), (4, 4)]


def test_checkpoint_file_is_atomic(tmp_path):
    scene = tp.get_scene("box", CFG.width, CFG.height)
    ck = str(tmp_path / "ck.npz")
    render_progressive(scene, CFG.replace(spp=2), ck, flush_every=1)
    assert os.path.exists(ck)
    assert not any(f.endswith(".tmp.npz") for f in os.listdir(tmp_path))
    jax_ck.render_progressive(pt.get_scene("box", 16, 12), JCFG.replace(spp=2),
                              str(tmp_path / "jax.npz"), flush_every=1)
    assert sorted(np.load(ck).files) == sorted(np.load(str(tmp_path / "jax.npz")).files)


def _invert_setup():
    cfg = tp.RenderConfig(width=10, height=8, spp=2, max_depth=6)
    scene = tp.get_scene("box", cfg.width, cfg.height)
    target = grad.render_target(scene, cfg)
    params0 = {k: v + 0.03 for k, v in grad.split_params(scene, ("albedo", "emission")).items()}
    return cfg, scene, target, params0


def test_invert_checkpoint_resume_is_exact(tmp_path):
    """Save at step 2, load into a new step function, continue: params and
    Adam's state equal the uninterrupted run's bitwise, and nothing of the
    state was cast or moved."""
    cfg, scene, target, params0 = _invert_setup()
    fp = invert_fingerprint(scene, cfg, ("albedo", "emission"), 1e-2)
    ck = str(tmp_path / "inv.npz")

    step = grad.make_accum_train_step(scene, cfg, 1e-2, cell_chunk=200)
    p = params0
    for _ in range(4):
        p, _ = step(p, target)
    straight = step.state_dict()

    step2 = grad.make_accum_train_step(scene, cfg, 1e-2, cell_chunk=200)
    p2 = params0
    for _ in range(2):
        p2, _ = step2(p2, target)
    sd = step2.state_dict()
    InvertState(sd["params"], sd["optimizer"], 2, fp).save(ck)

    st = load_or_init_invert(ck, fp, params0)
    assert st.step == 2
    step3 = grad.make_accum_train_step(scene, cfg, 1e-2, cell_chunk=200)
    step3.load_state_dict({"params": st.params, "optimizer": st.opt_state})
    p3 = st.params
    for _ in range(2):
        p3, _ = step3(p3, target)
    resumed = step3.state_dict()

    for k in p:
        assert torch.equal(p[k], p3[k]), k
    a, b = straight["optimizer"]["state"], resumed["optimizer"]["state"]
    assert sorted(a) == sorted(b) == [0, 1]
    for i in a:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert a[i][key].dtype == b[i][key].dtype and a[i][key].device == b[i][key].device
            assert torch.equal(a[i][key], b[i][key]), (i, key)


def test_invert_checkpoint_fingerprint_mismatch(tmp_path):
    cfg, scene, _, _ = _invert_setup()
    params = grad.split_params(scene, ("albedo",))
    fp = invert_fingerprint(scene, cfg, ("albedo",), 1e-2)
    ck = str(tmp_path / "inv.npz")
    InvertState(params, {"state": {}}, 3, fp).save(ck)

    other = invert_fingerprint(scene, cfg, ("albedo",), 5e-3)  # different lr
    with pytest.raises(ValueError, match="different"):
        load_or_init_invert(ck, other, params)


def test_invert_checkpoint_has_the_jax_keys(tmp_path):
    """The file holds the JAX InvertState's keys, leaf for leaf (optax's
    count, mu and nu beside Adam's step counter and moments)."""
    import optax

    from cpu_path_tracing_tpu.grad import split_params as jax_split

    cfg, scene, target, params0 = _invert_setup()
    step = grad.make_accum_train_step(scene, cfg, 1e-2)
    p, _ = step(params0, target)
    sd = step.state_dict()
    ours = str(tmp_path / "ours.npz")
    InvertState(sd["params"], sd["optimizer"], 1, "fp").save(ours)
    jp = jax_split(pt.get_scene("box", 10, 8), ("albedo", "emission"))
    theirs = str(tmp_path / "theirs.npz")
    jax_ck.InvertState(jp, optax.adam(1e-2).init(jp), 1, "fp").save(theirs)
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape, k
    np.testing.assert_array_equal(a["params_leaf_000"], p["albedo"].numpy())
    assert float(a["opt_leaf_000"]) == 1.0
