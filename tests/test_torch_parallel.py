"""The port's meshes, sharded renders and sharded inverse steps
(``cpu_path_tracing_tpu_torch/parallel/``, ``grad.make_sharded_*``), case
for case with ``tests/test_parallel.py``, on meshes of repeated CPU
devices (``['cpu'] * 8``, the torch form of conftest's virtual devices).

* A tiles-only mesh renders the one-device image bit for bit (keys depend
  only on (seed, cell, sample); a tile sums each cell's samples as one pass
  does), also when ``num_cells`` is no multiple of the tiles.
* A sample axis re-associates each cell's sum: 1e-6 absolute on the image.
* The 4x2 render agrees with the JAX ``render_image_sharded`` on conftest's
  8 virtual devices in float64 within 1e-12 (scale-aware).
* Both sharded inverse steps equal the port's one-device steps (themselves
  held to JAX in tests/test_torch_grad.py) in float64: loss within 1e-12,
  params after one Adam step rtol 1e-9, atol 1e-12 (JAX's own tolerances).
* ``cli render --mesh``, ``cli invert --mesh``, ``cli bench --scaling``,
  and ``entry.dryrun_multichip`` on ``['cpu'] * 8``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cpu_path_tracing_tpu.parallel.render import render_image_sharded as jax_render_image_sharded
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import cli, grad
from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh
from cpu_path_tracing_tpu_torch.parallel.render import (
    render_cells_sharded,
    render_image_sharded,
    replicate_scene,
)
from cpu_path_tracing_tpu_torch.utils.parity import scale_aware

torch.set_num_threads(1)

KW = dict(width=32, height=24, spp=4, max_depth=16)


def cpus(n):
    return ["cpu"] * n


def _single(name, cfg, dtype=torch.float32):
    return tp.render_image(tp.get_scene(name, cfg.width, cfg.height, dtype=dtype), cfg)


def test_mesh_shapes():
    m = make_mesh(devices=cpus(8))
    assert m.shape == {"tiles": 8, "samples": 1}
    m2 = make_mesh(n_tiles=4, n_samples=2, devices=cpus(8))
    assert m2.shape == {"tiles": 4, "samples": 2}
    assert m2.devices[3][1] == torch.device("cpu")
    assert m2.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="3x3 != 8"):
        make_mesh(n_tiles=3, n_samples=3, devices=cpus(8))
    with pytest.raises(ValueError):
        make_mesh(n_tiles=0, n_samples=1, devices=[])


def test_default_mesh_is_the_visible_cards():
    """make_mesh() takes every visible CUDA device once, and names the
    missing card rather than falling back to the CPU."""
    count = torch.cuda.device_count()
    if count == 0:
        with pytest.raises(ValueError, match="no CUDA device"):
            make_mesh()
    else:
        assert make_mesh().shape == {"tiles": count, "samples": 1}


def test_replicate_scene_leaves_the_callers_scene_where_it_lives():
    """``nn.Module.to`` moves a module in place: every other device of the
    mesh gets a copy and the caller's scene stays put (the 'meta' device
    stands in for a second card, which a move would reach)."""
    scene = tp.get_scene("box", 8, 6)
    cpu, meta = torch.device("cpu"), torch.device("meta")
    scenes = replicate_scene(scene, make_mesh(2, 2, ["cpu", "meta", "meta", "cpu"]))
    assert list(scenes) == [cpu, meta] and scenes[cpu] is scene
    assert scene.device == scene.camera.position.device == cpu
    assert scenes[meta].device == scenes[meta].camera.position.device == meta


def test_tile_sharded_matches_single_device():
    cfg = tp.RenderConfig(**KW)
    scene = tp.get_scene("box", cfg.width, cfg.height)
    img = render_image_sharded(scene, cfg, make_mesh(n_tiles=8, devices=cpus(8)))
    assert torch.equal(img, _single("box", cfg))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
@pytest.mark.parametrize("name", ["box", "box_mirror"])
def test_sample_sharded_matches_single_device(name, shape):
    cfg = tp.RenderConfig(**KW)
    scene = tp.get_scene(name, cfg.width, cfg.height)
    img = render_image_sharded(scene, cfg, make_mesh(*shape, devices=cpus(8)))
    torch.testing.assert_close(img, _single(name, cfg), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["box", "box_mirror"])
def test_4x2_matches_jax_sharded_render_float64(name):
    assert len(jax.devices()) >= 8
    jcfg = pt.RenderConfig(**KW)
    ref = np.asarray(jax_render_image_sharded(
        pt.get_scene(name, jcfg.width, jcfg.height, dtype=jnp.float64), jcfg,
        jax_make_mesh(n_tiles=4, n_samples=2)))
    cfg = tp.RenderConfig(**KW)
    got = render_image_sharded(tp.get_scene(name, cfg.width, cfg.height, dtype=torch.float64),
                               cfg, make_mesh(4, 2, cpus(8))).numpy()
    assert got.dtype == ref.dtype == np.float64
    dev = scale_aware(got, ref)
    assert float(dev.max()) < 1e-12


def test_spp_not_divisible_raises():
    cfg = tp.RenderConfig(width=8, height=8, spp=3)
    with pytest.raises(ValueError, match="not divisible"):
        render_image_sharded(tp.get_scene("box", 8, 8), cfg, make_mesh(4, 2, cpus(8)))


@pytest.mark.parametrize("width,height,subpixels,n_tiles", [(5, 3, 2, 8), (5, 1, 1, 4)],
                         ids=["60_cells_8_tiles", "5_cells_4_tiles_one_all_padding"])
def test_padding_past_the_last_cell_is_dropped(width, height, subpixels, n_tiles):
    """The last tile renders ids past num_cells (a contiguous span), which
    are dropped; a tile of padding alone is skipped.  Bitwise to one pass."""
    cfg = tp.RenderConfig(width=width, height=height, spp=2, max_depth=8,
                          num_subpixels=subpixels)
    assert cfg.num_cells % n_tiles
    scene = tp.get_scene("box", width, height)
    cells = render_cells_sharded(scene, cfg, make_mesh(n_tiles, 1, cpus(n_tiles)))
    assert cells.shape == (cfg.num_cells, 3)
    assert torch.equal(tp.finalize_image(cells, cfg), _single("box", cfg))


ACC_CFG = tp.RenderConfig(width=10, height=8, spp=4, max_depth=8)


@pytest.fixture(scope="module")
def accum_reference():
    """The one-device accumulation step on the float64 box (JAX's test:
    cell_chunk 77, sample_chunk 2, target 0.9x the render)."""
    scene = tp.get_scene("box", ACC_CFG.width, ACC_CFG.height, dtype=torch.float64)
    target = grad.render_target(scene, ACC_CFG) * 0.9
    params0 = grad.split_params(scene, ("albedo", "emission"))
    ref = grad.make_accum_train_step(scene, ACC_CFG, 1e-2, cell_chunk=77, sample_chunk=2)
    p_ref, l_ref = ref(params0, target)
    return scene, target, params0, p_ref, l_ref


@pytest.mark.parametrize("shape,cc,sc", [((8, 1), None, None), ((4, 2), 100, 1),
                                         ((2, 4), 64, None)], ids=["8x1", "4x2", "2x4"])
def test_sharded_accum_train_step_matches_single_device(accum_reference, shape, cc, sc):
    scene, target, params0, p_ref, l_ref = accum_reference
    step = grad.make_sharded_accum_train_step(make_mesh(*shape, cpus(8)), scene, ACC_CFG, 1e-2,
                                              cell_chunk=cc, sample_chunk=sc)
    p, loss = step(params0, target)
    assert loss.dtype == torch.float64 and abs(float(loss) - float(l_ref)) < 1e-12
    for k in p_ref:
        np.testing.assert_allclose(p[k].numpy(), p_ref[k].numpy(), rtol=1e-9, atol=1e-12,
                                   err_msg=f"mesh={shape} chunk=({cc},{sc}) leaf={k}")


def test_sharded_accum_gradients_are_counted_once(accum_reference):
    """The gradient itself, not only Adam's sign-like first update: a
    gradient counted once per sample shard would be n_samples times too
    large (the trap of a differentiable all-reduce)."""
    scene, target, params0, _, _ = accum_reference
    l1, g1 = grad.make_accum_loss_grad(scene, ACC_CFG, cell_chunk=77, sample_chunk=2)(params0,
                                                                                   target)
    lg = grad.make_sharded_accum_loss_grad(make_mesh(2, 4, cpus(8)), scene, ACC_CFG,
                                           cell_chunk=64)
    l2, g2 = lg(params0, target)
    assert abs(float(l2) - float(l1)) < 1e-12
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-9, atol=1e-15,
                                   err_msg=k)


def test_sharded_accum_step_resumes_bitwise(accum_reference):
    """state_dict / load_state_dict as the one-device step has them: two
    steps straight equal one step, a reload into a new step function and
    one more."""
    scene, target, params0, _, _ = accum_reference
    mesh = make_mesh(2, 2, cpus(4))

    def make():
        return grad.make_sharded_accum_train_step(mesh, scene, ACC_CFG, 1e-2)

    straight = make()
    p, _ = straight(params0, target)
    p, _ = straight(p, target)
    first = make()
    q, _ = first(params0, target)
    again = make()
    again.load_state_dict(first.state_dict())
    q, _ = again(q, target)
    for k in p:
        assert torch.equal(p[k], q[k]), k


TRAIN_CFG = tp.RenderConfig(width=8, height=8, spp=4, max_depth=6, loop="scan")


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)], ids=["8x1", "4x2", "2x4"])
def test_sharded_train_step_matches_single_device(shape):
    scene = tp.get_scene("box", TRAIN_CFG.width, TRAIN_CFG.height, dtype=torch.float64)
    target = grad.render_target(scene, TRAIN_CFG) * 0.9
    ids = torch.arange(TRAIN_CFG.num_cells)

    def fresh():
        params = {k: v.clone().requires_grad_(True)
                  for k, v in grad.split_params(scene, ("albedo", "p0")).items()}
        return params, torch.optim.Adam(list(grad.flatten_params(params)[1]), lr=1e-2)

    params, opt = fresh()
    p_ref, l_ref = grad.train_step(params, opt, scene, TRAIN_CFG, ids, target)
    params, opt = fresh()
    step = grad.make_sharded_train_step(make_mesh(*shape, cpus(8)), TRAIN_CFG, opt)
    p, loss = step(params, scene, ids, target)
    assert abs(float(loss) - float(l_ref)) < 1e-12
    for k in p_ref:
        np.testing.assert_allclose(p[k].detach().numpy(), p_ref[k].detach().numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=f"mesh={shape} leaf={k}")


def test_cli_render_mesh_is_the_one_pass_png(tmp_path):
    small = ["--scene", "box", "--width", "16", "--height", "12", "--spp", "2", "--max-depth",
             "8", "--device", "cpu"]
    one, sharded = str(tmp_path / "one.png"), str(tmp_path / "mesh.png")
    assert cli.main(["render", *small, "-o", one]) == 0
    assert cli.main(["render", *small, "--mesh", "4x1", "-o", sharded]) == 0
    assert open(one, "rb").read() == open(sharded, "rb").read()
    with pytest.raises(SystemExit, match="TILESxSAMPLES"):
        cli.main(["render", *small, "--mesh", "4", "-o", sharded])


def test_cli_invert_mesh(capsys):
    argv = ["invert", "--scene", "box", "--width", "16", "--height", "12", "--spp", "2",
            "--max-depth", "8", "--steps", "3", "--cell-chunk", "200", "--device", "cpu"]
    assert cli.main([*argv, "--mesh", "2x2"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2]
    assert lines[-1]["loss"] < lines[0]["loss"]
    assert cli.main(argv) == 0
    single = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    # Float32 on one device and on the mesh: the sums re-associated only.
    for a, b in zip(lines, single):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"]


def test_cli_bench_scaling_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "scaling.md")
    assert cli.main(["bench", "--scaling", "--scene", "box", "--width", "16", "--height", "12",
                     "--spp", "1", "--max-depth", "8", "--repeats", "2", "--suite-out", out,
                     "--device", "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in rows] == [1] and rows[0]["speedup"] == 1.0
    assert rows[0]["device"] == "cpu" and rows[0]["seconds"] > 0
    text = open(out).read()
    assert text.startswith("# Mesh-scaling PLUMBING GATE") and "| 1 |" in text


def test_entry_and_dryrun_multichip_on_cpus():
    from cpu_path_tracing_tpu_torch.entry import dryrun_multichip, entry

    fn, (scene, ids) = entry("cpu")
    assert scene.device.type == "cpu" and ids.shape == (256 * 192 * 4,)
    cfg = tp.RenderConfig(width=256, height=192, spp=4, max_depth=100)
    head = ids[:256]
    assert torch.equal(fn(scene, head), tp.render_cells(scene, cfg, head))
    out = dryrun_multichip(8, cpus(8))
    assert out["mesh"] == {"tiles": 4, "samples": 2}
    assert all(np.isfinite(out[k]) for k in ("loss", "accum_loss", "pallas_mesh_mean"))
