"""The benchmark's reference against the port on the CPU at tiny sizes:
the image bitwise, the loss, the albedo, emission, p0 and radius
gradients, and the work counts against the port's plain versions."""

import copy
import json

import pytest
import torch

from harness import port
from harness.spec import BENCH_DIR
from plainref import fit as ref_fit
from plainref import render as ref_render
from plainref.scene import build_scene, with_params


def _config(name, **kw):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    cfg.update(kw)
    return cfg


def _open_box(**kw):
    """The box without its back and right walls: paths end on a miss, so
    p0 and radius have gradients."""
    cfg = _config("box_400x400", **kw)
    cfg["scene"] = copy.deepcopy(cfg["scene"])
    del cfg["scene"]["spheres"][1:3]
    return cfg


@pytest.mark.parametrize("name", ["disco_1024x768", "box_400x400"])
def test_image_is_bitwise_the_ports(name):
    import cpu_path_tracing_tpu_torch as tp

    cfg = _config(name, width=24, height=16)
    seed = 2**33 + 5
    img = tp.render_image(port.scene(cfg, "cpu"), port.render_config(cfg, 2, seed))
    ref = ref_render.finalize(ref_render.cell_means(build_scene(cfg, "cpu"), cfg, 2, seed, 300),
                              cfg)
    assert torch.equal(img, ref)


def test_scene_is_the_ports_registered_scene():
    import cpu_path_tracing_tpu_torch as tp

    for name, scene in (("disco_1024x768", "box_mirror"), ("box_400x400", "box")):
        cfg = _config(name)
        ours, theirs = build_scene(cfg, "cpu"), tp.get_scene(scene, cfg["width"], cfg["height"])
        for f in ("p0", "radius", "anchor_dir", "emission", "albedo", "background"):
            assert torch.equal(getattr(ours, f), getattr(theirs, f)), (name, f)


def test_loss_and_gradients_agree_with_the_ports():
    from cpu_path_tracing_tpu_torch import grad

    cfg = _open_box(width=12, height=10, spp=2, cell_chunk=200)
    seed, fields = 91, ("albedo", "emission", "p0", "radius")
    scene = port.scene(cfg, "cpu")
    rcfg = port.render_config(cfg, 2, seed)
    target = grad.render_target(scene, rcfg, 200)
    truth = build_scene(cfg, "cpu")
    start = {f: getattr(truth, f) + 0.02 for f in fields}
    loss, g = grad.make_accum_loss_grad(scene, rcfg, cell_chunk=200, sample_chunk=1)(
        dict(start), target)
    ref_target = ref_render.cell_means(truth, cfg, 2, seed, 100)
    rloss, rg = ref_fit.loss_and_grads(truth, cfg, 2, seed, start, ref_target, 200, 70)
    assert torch.equal(target, ref_target) and float(loss) == float(rloss)
    for f in fields:
        scale = float(rg[f].abs().max())
        assert scale > 0, f
        assert float((g[f] - rg[f]).abs().max()) <= 1e-4 * scale, f


def test_adam_is_torchs():
    p = {"a": torch.tensor([0.5, -1.0, 2.0])}
    opt_p = p["a"].clone().requires_grad_(True)
    opt = torch.optim.Adam([opt_p], lr=1e-2)
    ours = ref_fit.Adam(1e-2)
    for k in range(3):
        g = torch.tensor([0.1, -0.2, 0.3]) * (k + 1)
        opt_p.grad = g.clone()
        opt.step()
        p = ours.step(p, {"a": g})
    assert torch.allclose(p["a"], opt_p.detach(), rtol=0, atol=1e-7)


def test_counts_match_the_ports_plain_versions():
    from cpu_path_tracing_tpu_torch.ops import replay as pr
    from cpu_path_tracing_tpu_torch.ops.kernels import geometry_replay as gk
    from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk
    from cpu_path_tracing_tpu_torch.render import camera_rays

    cfg = _open_box(width=10, height=8)
    seed = 7
    scene = port.scene(cfg, "cpu")
    rcfg = port.render_config(cfg, 1, seed)
    n = rcfg.num_cells
    ids = torch.arange(n)
    keys, o, d = camera_rays(scene, rcfg, ids, 0, torch.float32)
    kw = dict(max_depth=100, rr_depth=4, epsilon=1e-4, inf=1e20)
    _, st = pr.replay_items(scene, o, d, keys, torch.ones(n, 3), acc_dtype=torch.float64, **kw)
    table_kw = dict(cfg=rcfg, n_cells=n, n_items=n, ior=scene.ior)

    _, gst = gk.geometry_replay(mk.pack_scene(scene), mk.pack_camera(scene), (0, 0),
                                torch.ones(n, 3), **table_kw)
    _, c = ref_render.cell_sums(build_scene(cfg, "cpu"), cfg, 0, n, 1, seed, count=True)
    assert c["segments"] == st["segments"] == int(gst["segments"])
    assert c["prefix_terms"] == st["prefix_terms"]
    assert c["missed"] == int(gst["missed"]) > 0
    assert c["sweep_bounces"] == int(gst["sweep_bounces"])
    assert c["tied_bounces"] == int(gst["tied_bounces"])


def test_with_params_leaves_the_scene_alone():
    truth = build_scene(_config("box_400x400"), "cpu")
    moved = with_params(truth, {"albedo": truth.albedo + 1})
    assert torch.equal(moved.albedo, truth.albedo + 1) and not torch.equal(moved.albedo,
                                                                          truth.albedo)
