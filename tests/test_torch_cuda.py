"""The CUDA kernel on the card (skipped where there is none).

Run on a machine with an NVIDIA GPU:
    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
This file imports no JAX, so it runs where JAX is not installed;
``--noconftest`` skips tests/conftest.py, which imports it.
"""

import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch.ops import rng as rng_ops
from cpu_path_tracing_tpu_torch.ops import wavefront
from cpu_path_tracing_tpu_torch.ops.geometry_replay import geometry_partial_blocks
from cpu_path_tracing_tpu_torch.ops.kernels import geometry_replay as gk
from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk
from cpu_path_tracing_tpu_torch.ops.kernels import probe as pk
from cpu_path_tracing_tpu_torch.ops.kernels import replay as rk
from cpu_path_tracing_tpu_torch.ops.replay import partial_blocks
from cpu_path_tracing_tpu_torch.utils.parity import tier1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["box_mirror", "simple", "smallpt_exact"])
def test_kernel_matches_plain_version(cuda, name):
    """Tier 1 of the parity gate at max_depth 8: scale-aware deviation
    p99.9 < 1e-5 and < 0.1% of items above 1e-3."""
    cfg = tp.RenderConfig(width=32, height=24, spp=2, max_depth=8)
    scene = tp.get_scene(name, 32, 24)
    args = (mk.pack_scene(scene).to(cuda), mk.pack_camera(scene).to(cuda), (0, 0))
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=2 * cfg.num_cells, ior=scene.ior)
    got, st = mk.persistent_render(*args, **kw)
    ref, ref_st = mk.persistent_render_reference(*args, **kw)
    torch.cuda.synchronize()
    a, b = got.cpu().numpy(), ref.cpu().numpy()
    assert tier1(a, b, axis=0)["ok"]
    assert int(st["segments"]) > 0 and st["lanes"] > 0 and int(st["iters"]) > 0


def test_regenerating_launch_matches_plain_version(cuda):
    """More items than threads, so each thread starts further items, at a
    nonzero cell_start and sample_start, over a span that runs past the last
    cell (clamped to it): tier 1 as above."""
    cfg = tp.RenderConfig(width=256, height=192, spp=8, max_depth=8)
    scene = tp.get_scene("box_mirror", 256, 192)
    args = (mk.pack_scene(scene).to(cuda), mk.pack_camera(scene).to(cuda), (150_001, 5))
    kw = dict(cfg=cfg, n_cells=80_000, n_items=3 * 80_000, ior=scene.ior)
    got, st = mk.persistent_render(*args, **kw)
    ref, _ = mk.persistent_render_reference(*args, **kw)
    torch.cuda.synchronize()
    assert st["lanes"] < kw["n_items"]
    a, b = got.cpu().numpy(), ref.cpu().numpy()
    assert tier1(a, b, axis=0)["ok"]


@pytest.mark.parametrize("n_cells, samples", [(12_345, 3), (7, 3), (1, 1), (33, 1)])
def test_odd_sized_spans_match_plain_version_bitwise(cuda, n_cells, samples):
    """Spans whose item count is no multiple of 32, or smaller than a warp:
    the last chunk a warp owns is ragged, and some warps own nothing.  The
    forward kernel bitwise; the replay kernel, whose warp-owned item map
    (csrc/replay.cu: owned_positions, item_at) must reach every item once,
    with the plain version's segment count and within its block limits."""
    cfg = tp.RenderConfig(width=256, height=192, spp=8, max_depth=100)
    scene = tp.get_scene("box_mirror", 256, 192)
    args = (mk.pack_scene(scene).to(cuda), mk.pack_camera(scene).to(cuda), (777, 3))
    kw = dict(cfg=cfg, n_cells=n_cells, n_items=samples * n_cells, ior=scene.ior)
    got, st = mk.persistent_render(*args, **kw)
    ref, ref_st = mk.persistent_render_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and int(st["segments"]) == ref_st["segments"]
    ct = torch.from_numpy(np.random.default_rng(n_cells).normal(0, 1, (n_cells, 3))
                          .astype(np.float32)).to(cuda)
    part, pst = rk.replay_persistent(*args, ct, **kw)
    want, want_st = rk.replay_persistent_reference(*args, ct, **kw)
    assert int(pst["segments"]) == want_st["segments"] == ref_st["segments"]
    for name, sl in partial_blocks(scene.num_spheres).items():
        g, r = part[sl].cpu(), want[sl].cpu()
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-7, name


def test_spans_past_two_to_the_31_take_the_64_bit_kernels(cuda):
    """A 32768 x 32768 image has 2^32 cells: a span past 2^31 makes the
    wrappers choose 64-bit items.  Forward bitwise, replay within its block
    limits and repeating bitwise."""
    cfg = tp.RenderConfig(width=32768, height=32768, spp=8, max_depth=100)
    scene = tp.get_scene("box", cfg.width, cfg.height)
    dyn, n_cells = (2**31 + 12_345, 3), 5_000
    params = mk.launch_params(cfg, dyn, n_spheres=scene.num_spheres, n_cells=n_cells,
                              n_items=2 * n_cells, ior=scene.ior)
    assert mk.index_bits(params) == 64
    ct = np.random.default_rng(4).normal(0, 1, (n_cells, 3)).astype(np.float32)
    args = (mk.pack_scene(scene).to(cuda), mk.pack_camera(scene).to(cuda), dyn)
    kw = dict(cfg=cfg, n_cells=n_cells, n_items=2 * n_cells, ior=scene.ior)
    got, st = mk.persistent_render(*args, **kw)
    ref, ref_st = mk.persistent_render_reference(*args, **kw)
    assert torch.equal(got, ref) and int(st["segments"]) == ref_st["segments"]
    part, pst = rk.replay_persistent(*args, torch.from_numpy(ct).to(cuda), **kw)
    again, _ = rk.replay_persistent(*args, torch.from_numpy(ct).to(cuda), **kw)
    want, want_st = rk.replay_persistent_reference(*args, torch.from_numpy(ct).to(cuda), **kw)
    assert torch.equal(part, again) and int(pst["segments"]) == want_st["segments"]
    for name, sl in partial_blocks(scene.num_spheres).items():
        g, r = part[sl].cpu(), want[sl].cpu()
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-7, name


@pytest.mark.parametrize("name", ["box_mirror", "simple", "smallpt_exact", "random_spheres"])
def test_kernel_is_bitwise_equal_to_plain_version(cuda, name):
    """Scenes of 8, 5, 10 and 100 spheres (the sphere loop takes one sphere a
    trip, whatever the count) at max_depth 100: every item bitwise, segments
    equal."""
    cfg = tp.RenderConfig(width=32, height=24, spp=2, max_depth=100)
    scene = tp.get_scene(name, 32, 24)
    args = (mk.pack_scene(scene).to(cuda), mk.pack_camera(scene).to(cuda), (0, 0))
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=2 * cfg.num_cells, ior=scene.ior)
    got, st = mk.persistent_render(*args, **kw)
    ref, ref_st = mk.persistent_render_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and int(st["segments"]) == ref_st["segments"]


def test_render_image_launches_the_kernel(cuda):
    cfg = tp.RenderConfig(width=32, height=24, spp=2, max_depth=16)
    before = mk.persistent_render.launches
    img = tp.render_image(tp.get_scene("box", 32, 24).to(cuda), cfg)
    assert mk.persistent_render.launches == before + 1
    assert img.device.type == "cuda" and img.shape == (24, 32, 3)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0


def _tier1(a, b):
    """The strict gate: per-item scale-aware deviation p99.9 < 1e-5 and
    < 0.1% of items above 1e-3."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return tier1(a, b, axis=0)["ok"]


@pytest.mark.parametrize("name", ["box_mirror", "simple", "smallpt_exact"])
def test_step_kernel_matches_plain_step_and_whole_render_kernel(cuda, name):
    """The per-step kernel's per-item radiance: tier 1 against its plain
    version on the card, and bitwise equal to the whole-render kernel's,
    with equal segment counts (the same start_path and bounce, -fmad=false)."""
    cfg = tp.RenderConfig(width=32, height=24, spp=2, max_depth=8)
    scene = tp.get_scene(name, 32, 24).to(cuda)
    ids = torch.arange(cfg.num_cells, device=cuda)
    before = mk.megakernel_step.launches
    got, st = wavefront.drive_items(mk.megakernel_step, scene, cfg, ids, 0, 2, lanes=1000)
    launched = mk.megakernel_step.launches - before
    assert launched * wavefront.STEPS_PER_LAUNCH >= st["iters"] > 0
    assert launched % wavefront.STEP_BATCH == 0
    ref, ref_st = wavefront.drive_items(mk.megakernel_step_reference, scene, cfg, ids, 0, 2,
                                        lanes=1000)
    whole, whole_st = mk.persistent_render(mk.pack_scene(scene), mk.pack_camera(scene), (0, 0),
                                           cfg=cfg, n_cells=cfg.num_cells,
                                           n_items=2 * cfg.num_cells, ior=scene.ior)
    torch.cuda.synchronize()
    assert _tier1(got, ref) and st["segments"] == ref_st["segments"]
    assert torch.equal(got, whole) and st["segments"] == int(whole_st["segments"])


def test_regenerating_step_kernel(cuda):
    """Fewer lanes than items, so each lane starts several items, at a
    nonzero cell_start and sample_start, over a span that runs past the last
    cell (clamped to it): bitwise equal to the whole-render kernel, tier 1
    against the plain step."""
    cfg = tp.RenderConfig(width=256, height=192, spp=8, max_depth=8)
    scene = tp.get_scene("box_mirror", 256, 192).to(cuda)
    ids = torch.arange(150_001, 150_001 + 80_000, device=cuda)
    got, st = wavefront.drive_items(mk.megakernel_step, scene, cfg, ids, 5, 3, lanes=50_000)
    ref, _ = wavefront.drive_items(mk.megakernel_step_reference, scene, cfg, ids, 5, 3,
                                   lanes=50_000)
    whole, _ = mk.persistent_render(mk.pack_scene(scene), mk.pack_camera(scene), (150_001, 5),
                                    cfg=cfg, n_cells=80_000, n_items=3 * 80_000, ior=scene.ior)
    torch.cuda.synchronize()
    assert st["lanes"] == 50_000 and 150_001 + 80_000 > cfg.num_cells
    assert torch.equal(got, whole) and _tier1(got, ref)


@pytest.mark.parametrize("steps", [2, 4, 32])
def test_step_kernel_with_steps_equals_single_launches_and_plain_version(cuda, steps):
    """One launch of S steps against S launches of one step, from the
    first launch through regenerating lanes to past the drain: the state
    (``lane_state_equal``), ``out`` and every ``seg`` slot bitwise.  Then
    against the plain version run the same way: counts equal, radiance by
    tier 1."""
    cfg = tp.RenderConfig(width=64, height=48, spp=2, max_depth=8)
    scene = tp.get_scene("box_mirror", 64, 48).to(cuda)
    args = (mk.pack_scene(scene), mk.pack_camera(scene), (1_001, 3))
    n_cells, lanes = 12_000, 5_000  # past the last cell (12,288); 5 generations
    n_items = 2 * n_cells
    launches = -(-(5 * cfg.max_depth + 1) // steps) + 1
    kw = dict(cfg=cfg, n_cells=n_cells, n_items=n_items, lanes=lanes, ior=scene.ior)

    def fresh():
        return (mk.init_lane_state(lanes, cuda), torch.zeros((3, n_items), device=cuda),
                torch.zeros(launches * steps, dtype=torch.int64, device=cuda))

    (sa, oa, ga), (sb, ob, gb), (sc, oc, gc) = fresh(), fresh(), fresh()
    before = mk.megakernel_step.launches
    for n in range(launches):
        mk.megakernel_step(sa, *args, out=oa, seg=ga, seg_slot=n * steps, steps=steps, **kw)
        for j in range(steps):
            mk.megakernel_step(sb, *args, out=ob, seg=gb, seg_slot=n * steps + j, **kw)
        assert mk.lane_state_equal(sa, sb), n
        mk.megakernel_step_reference(sc, *args, out=oc, seg=gc, seg_slot=n * steps,
                                     steps=steps, **kw)
    torch.cuda.synchronize()
    assert mk.megakernel_step.launches - before == launches * (1 + steps)
    assert torch.equal(oa, ob) and torch.equal(ga, gb)
    assert int(ga[-steps:].sum()) == 0 and int(sa.i[4].sum()) == 0  # drained
    assert torch.equal(ga, gc) and torch.equal(sa.i[3:], sc.i[3:]) and _tier1(oa, oc)


def test_graph_driven_loop_equals_launch_by_launch(cuda):
    """``drive_items`` with the kernel wrapper itself replays a captured
    batch; with any other callable it launches one by one.  On a
    regenerating span at a nonzero cell_start and sample_start both give
    the same radiance bitwise and the same stats, and the graph-driven loop
    counts STEP_BATCH launches per batch."""
    cfg = tp.RenderConfig(width=256, height=192, spp=8, max_depth=100)
    scene = tp.get_scene("box_mirror", 256, 192).to(cuda)
    ids = torch.arange(150_001, 150_001 + 80_000, device=cuda)
    before = mk.megakernel_step.launches
    got, st = wavefront.drive_items(mk.megakernel_step, scene, cfg, ids, 5, 3, lanes=50_000)
    graphed = mk.megakernel_step.launches - before
    one_by_one, ref_st = wavefront.drive_items(lambda *a, **k: mk.megakernel_step(*a, **k),
                                               scene, cfg, ids, 5, 3, lanes=50_000)
    torch.cuda.synchronize()
    assert torch.equal(got, one_by_one) and st == ref_st and st["iters"] > 100
    assert graphed == mk.megakernel_step.launches - before - graphed
    assert graphed % wavefront.STEP_BATCH == 0
    assert graphed * wavefront.STEPS_PER_LAUNCH >= st["iters"] + 1


def test_step_batch_rejects_a_wrong_count_block(cuda):
    cfg = tp.RenderConfig(width=32, height=24, spp=1, max_depth=4)
    scene = tp.get_scene("box", 32, 24).to(cuda)
    n = cfg.num_cells
    kw = dict(batch=4, steps=2, cfg=cfg, n_cells=n, n_items=n, lanes=256,
              out=torch.zeros((3, n), device=cuda), ior=scene.ior)
    args = (mk.init_lane_state(256, cuda), mk.pack_scene(scene), mk.pack_camera(scene), (0, 0))
    with pytest.raises(ValueError, match="batch \\* steps"):
        mk.megakernel_step_batch(*args, seg=torch.zeros(7, dtype=torch.int64, device=cuda), **kw)
    with pytest.raises(ValueError, match="batch"):
        mk.megakernel_step_batch(*args, seg=torch.zeros(8, dtype=torch.int64, device=cuda),
                                 **dict(kw, batch=0))


def test_render_image_per_step_launches_the_step_kernel(cuda):
    cfg = tp.RenderConfig(width=32, height=24, spp=2, max_depth=16, integrator="pallas",
                          pallas_persistent=False)
    scene = tp.get_scene("box", 32, 24).to(cuda)
    steps, whole = mk.megakernel_step.launches, mk.persistent_render.launches
    img = tp.render_image(scene, cfg)
    assert mk.megakernel_step.launches > steps and mk.persistent_render.launches == whole
    assert torch.equal(img, tp.render_image(scene, cfg.replace(pallas_persistent=True)))


def _replay_launch(cuda):
    """A regenerating replay launch (more items than threads) at a nonzero
    cell_start and sample_start, over a span that runs past the last cell."""
    cfg = tp.RenderConfig(width=256, height=192, spp=8, max_depth=100)
    scene = tp.get_scene("box", 256, 192)
    ct = np.random.default_rng(7).normal(0, 1, (80_000, 3)).astype(np.float32)
    args = (mk.pack_scene(scene).to(cuda), mk.pack_camera(scene).to(cuda), (150_001, 5),
            torch.from_numpy(ct).to(cuda))
    kw = dict(cfg=cfg, n_cells=80_000, n_items=3 * 80_000, ior=scene.ior)
    return scene, args, kw


def test_replay_kernel_matches_plain_version(cuda):
    """The replay kernel against its plain version (float64 accumulation):
    segments equal, each partial block within 1e-4 of its largest
    magnitude + 1e-7."""
    scene, args, kw = _replay_launch(cuda)
    before = rk.replay_persistent.launches
    got, st = rk.replay_persistent(*args, **kw)
    ref, ref_st = rk.replay_persistent_reference(*args, **kw)
    torch.cuda.synchronize()
    assert rk.replay_persistent.launches == before + 1 and st["lanes"] < kw["n_items"]
    assert int(st["segments"]) == ref_st["segments"]
    for name, sl in partial_blocks(scene.num_spheres).items():
        g, r = got[sl].cpu(), ref[sl].cpu()
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-7, name


def test_replay_kernel_is_bitwise_repeatable(cuda):
    _, args, kw = _replay_launch(cuda)
    first, _ = rk.replay_persistent(*args, **kw)
    second, _ = rk.replay_persistent(*args, **kw)
    assert torch.equal(first, second)


@pytest.mark.parametrize("n_spheres", [12, 16, 23, 40])
def test_replay_kernel_buckets_above_eight_spheres(cuda, n_spheres):
    """The 16- and 40-sphere buckets (their partials ask for more than 48 KB
    of shared memory) on the first spheres of random_spheres: the block
    limits, segments equal, two launches bitwise equal, odd item count."""
    full = tp.get_scene("random_spheres", 64, 48)
    spheres = [(float(full.radius[i]),
                (full.p0[i] - full.radius[i] * full.anchor_dir[i]).tolist(),
                full.emission[i].tolist(), full.albedo[i].tolist(), int(full.material[i]))
               for i in range(n_spheres)]
    scene = tp.scene_from_spheres(spheres, full.camera)
    cfg = tp.RenderConfig(width=64, height=48, spp=3, max_depth=100)
    n_cells = cfg.num_cells - 5
    ct = np.random.default_rng(3).normal(0, 1, (n_cells, 3)).astype(np.float32)
    args = (mk.pack_scene(scene).to(cuda), mk.pack_camera(scene).to(cuda), (5, 1),
            torch.from_numpy(ct).to(cuda))
    kw = dict(cfg=cfg, n_cells=n_cells, n_items=3 * n_cells, ior=scene.ior)
    got, st = rk.replay_persistent(*args, **kw)
    again, _ = rk.replay_persistent(*args, **kw)
    ref, ref_st = rk.replay_persistent_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and int(st["segments"]) == ref_st["segments"]
    for name, sl in partial_blocks(n_spheres).items():
        g, r = got[sl].cpu(), ref[sl].cpu()
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-7, name


def test_replay_kernel_repeats_bitwise_on_a_full_train_chunk(cuda):
    """The production inverse step's chunk (box 400x400, 131,072 cells, 16
    samples, max_depth 100): two launches give bitwise-equal partials."""
    cfg = tp.RenderConfig(width=400, height=400, spp=16, max_depth=100)
    scene = tp.get_scene("box", 400, 400)
    chunk = 1 << 17
    ct = np.random.default_rng(9).normal(0, 1, (chunk, 3)).astype(np.float32)
    args = (mk.pack_scene(scene).to(cuda), mk.pack_camera(scene).to(cuda), (0, 0),
            torch.from_numpy(ct).to(cuda))
    kw = dict(cfg=cfg, n_cells=chunk, n_items=cfg.spp * chunk, ior=scene.ior)
    first, st = rk.replay_persistent(*args, **kw)
    second, _ = rk.replay_persistent(*args, **kw)
    assert torch.equal(first, second) and st["lanes"] < kw["n_items"]


def _leaf_grads(scene, cfg, fields):
    """The gradient of the full-image loss against a 0.9x target, by leaf."""
    from cpu_path_tracing_tpu_torch import grad

    target = grad.render_target(scene, cfg) * 0.9
    _, g = grad.make_accum_loss_grad(scene, cfg, sample_chunk=1)(
        grad.split_params(scene, fields), target)
    return {n: v.double().cpu() for n, v in zip(*grad.flatten_params(g))}


@pytest.mark.parametrize("name", ["simple", "box"])
def test_geometry_gradients_match_the_cpu_in_float64(cuda, name):
    """Every optimizable field's gradient (the scan VJP) on the card within
    1e-9 of the CPU's, relative to the field's largest magnitude (the
    camera's over its eight leaves: ``origin_advance``'s is zero up to
    rounding); box's p0 and radius gradients exactly 0."""
    from cpu_path_tracing_tpu_torch import grad

    cfg = tp.RenderConfig(width=16, height=12, spp=2, max_depth=100)
    ref = _leaf_grads(tp.get_scene(name, 16, 12, dtype=torch.float64), cfg, grad.OPTIMIZABLE)
    got = _leaf_grads(tp.get_scene(name, 16, 12, dtype=torch.float64).to(cuda), cfg,
                      grad.OPTIMIZABLE)
    for n, r in ref.items():
        field = [m for m in ref if m.split(".")[0] == n.split(".")[0]]
        scale = max(float(ref[m].abs().max()) for m in field)
        assert float((got[n] - r).abs().max()) <= 1e-9 * scale, n
    if name == "box":
        assert float(got["p0"].abs().max()) == 0.0 and float(got["radius"].abs().max()) == 0.0


def test_geometry_gradients_repeat_bitwise_on_the_card(cuda):
    """Float32 p0, radius and camera gradients: two backward passes give
    bitwise-equal, finite gradients, the forward through the forward kernel,
    the backward through the geometry replay kernel (one launch a pass) and
    no replay kernel launch."""
    cfg = tp.RenderConfig(width=32, height=24, spp=2, max_depth=100)
    scene = tp.get_scene("simple", 32, 24).to(cuda)
    fwd, rep, geo = (mk.persistent_render.launches, rk.replay_persistent.launches,
                     gk.geometry_replay.launches)
    first = _leaf_grads(scene, cfg, ("p0", "radius", "camera"))
    second = _leaf_grads(scene, cfg, ("p0", "radius", "camera"))
    assert mk.persistent_render.launches > fwd and rk.replay_persistent.launches == rep
    assert gk.geometry_replay.launches == geo + 2
    for n in first:
        assert torch.equal(first[n], second[n]) and bool(torch.isfinite(first[n]).all()), n


def _geometry_launch(cuda, name, width, height, spp, depth, dyn, n_cells):
    cfg = tp.RenderConfig(width=width, height=height, spp=spp, max_depth=depth)
    scene = tp.get_scene(name, width, height)
    ct = np.random.default_rng(n_cells).normal(0, 1, (n_cells, 3)).astype(np.float32)
    args = (mk.pack_scene(scene).to(cuda), mk.pack_camera(scene).to(cuda), dyn,
            torch.from_numpy(ct).to(cuda))
    return scene, args, dict(cfg=cfg, n_cells=n_cells, n_items=spp * n_cells, ior=scene.ior)


def _geometry_blocks_ok(got, ref, n_spheres):
    for name, sl in geometry_partial_blocks(n_spheres).items():
        g, r = got[sl].cpu(), ref[sl].cpu()
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-7, name


@pytest.mark.parametrize("name,depth", [("simple", 8), ("simple", 100), ("new_camera", 100),
                                        ("box_mirror", 100)])
def test_geometry_replay_kernel_matches_plain_version(cuda, name, depth):
    """The geometry replay kernel's [4N+14] partials against its plain
    version (the same float32 decisions, float64 adjoints) at 64x48, 2 spp:
    segments, swept paths and swept bounces equal, each block (p0, radius,
    camera) within 1e-4 of its largest magnitude + 1e-7."""
    scene, args, kw = _geometry_launch(cuda, name, 64, 48, 2, depth, (0, 0), 64 * 48 * 4)
    before = gk.geometry_replay.launches
    got, st = gk.geometry_replay(*args, **kw)
    ref, ref_st = gk.geometry_replay_reference(*args, **kw)
    torch.cuda.synchronize()
    assert gk.geometry_replay.launches == before + 1
    for k in ("segments", "missed", "sweep_bounces", "tied_bounces"):
        assert int(st[k]) == ref_st[k], k
    _geometry_blocks_ok(got, ref, scene.num_spheres)


def _tie_scene(rows, width, height):
    """simple with its spheres taken in the order ``rows``: a copy's roots
    equal the original's bit for bit, so every hit on it ties exactly."""
    from cpu_path_tracing_tpu_torch.models.scene import Scene

    simple = tp.get_scene("simple", width, height)
    idx = torch.tensor(rows)
    return Scene(**{f: getattr(simple, f)[idx] for f in ("p0", "radius", "anchor_dir", "emission",
                                                         "albedo", "material")},
                 background=simple.background, camera=simple.camera, ior=simple.ior)


@pytest.mark.parametrize("depth", [8, 100])
@pytest.mark.parametrize("rows", [[0, 1, 2, 3, 4, 0, 1, 2, 3, 4], [0, 1, 2, 3, 4, 1, 1]],
                         ids=["duplicated", "tripled"])
def test_geometry_replay_kernel_splits_ties_as_plain_version(cuda, rows, depth):
    """Spheres whose roots tie exactly (simple with every sphere twice, and
    with its right sphere three times) at 64x48, 2 spp: the kernel splits
    t's adjoint among them as its plain version does, each block within
    1e-4 of its largest magnitude + 1e-7; the tied bounces it swept, more
    than 0, and every other count equal to the plain version's; two launches
    bitwise equal."""
    scene = _tie_scene(rows, 64, 48)
    cfg = tp.RenderConfig(width=64, height=48, spp=2, max_depth=depth)
    ct = np.random.default_rng(depth).normal(0, 1, (cfg.num_cells, 3)).astype(np.float32)
    args = (mk.pack_scene(scene).to(cuda), mk.pack_camera(scene).to(cuda), (0, 0),
            torch.from_numpy(ct).to(cuda))
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=2 * cfg.num_cells, ior=scene.ior)
    got, st = gk.geometry_replay(*args, **kw)
    again, _ = gk.geometry_replay(*args, **kw)
    ref, ref_st = gk.geometry_replay_reference(*args, **kw)
    torch.cuda.synchronize()
    assert int(st["tied_bounces"]) == ref_st["tied_bounces"] > 0
    for k in ("segments", "missed", "sweep_bounces"):
        assert int(st[k]) == ref_st[k], k
    _geometry_blocks_ok(got, ref, scene.num_spheres)
    assert torch.equal(got, again)


@pytest.mark.parametrize("name", ["box", "simple"])
def test_geometry_replay_kernel_repeats_bitwise(cuda, name):
    """A closed scene (box: no path ends on a miss, every record stored and
    none swept) and an open one (simple: nearly every path swept) at
    128x96, 4 spp, max_depth 100: two launches bitwise equal, the plain
    version's counts and block limits."""
    scene, args, kw = _geometry_launch(cuda, name, 128, 96, 4, 100, (0, 0), 128 * 96 * 4)
    got, st = gk.geometry_replay(*args, **kw)
    again, st2 = gk.geometry_replay(*args, **kw)
    ref, ref_st = gk.geometry_replay_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for k in ("segments", "missed", "sweep_bounces", "tied_bounces"):
        assert int(st[k]) == int(st2[k]) == ref_st[k], k
    assert (ref_st["missed"] == 0) == (name == "box")
    _geometry_blocks_ok(got, ref, scene.num_spheres)


def test_geometry_replay_kernel_repeats_bitwise_at_an_offset(cuda):
    """More items than threads, at a nonzero cell_start and sample_start
    over a span whose item count is no multiple of 32: two launches bitwise
    equal, and the plain version's counts and block limits."""
    scene, args, kw = _geometry_launch(cuda, "simple", 256, 192, 8, 100, (30_001, 5), 60_003)
    got, st = gk.geometry_replay(*args, **kw)
    again, _ = gk.geometry_replay(*args, **kw)
    ref, ref_st = gk.geometry_replay_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and st["lanes"] < kw["n_items"]
    assert int(st["missed"]) == ref_st["missed"] > 0
    _geometry_blocks_ok(got, ref, scene.num_spheres)


def test_geometry_route_launches_the_kernels_on_the_card(cuda):
    """``make_accum_loss_grad`` on a float32 CUDA scene with p0, radius,
    emission and camera over 4 cell chunks: the 'geometry' route, 4
    geometry and 4 replay kernel launches and no scan VJP, each field within
    1e-3 of its largest magnitude of the CPU's scan VJP; random_spheres (100
    spheres) takes the scan VJP on the card with no geometry launch."""
    from cpu_path_tracing_tpu_torch import grad

    fields = ("p0", "radius", "emission", "camera")
    cfg = tp.RenderConfig(width=32, height=24, spp=2, max_depth=100)

    def grads(scene):
        target = grad.render_target(scene, cfg) * 0.9
        _, g = grad.make_accum_loss_grad(scene, cfg, cell_chunk=768)(
            grad.split_params(scene, fields), target)
        return {n: v.double().cpu() for n, v in zip(*grad.flatten_params(g))}

    ref = grads(tp.get_scene("simple", 32, 24))
    scene = tp.get_scene("simple", 32, 24).to(cuda)
    assert grad.backward_route(scene, cfg, fields) == "geometry"
    geo, rep = gk.geometry_replay.launches, rk.replay_persistent.launches
    got = grads(scene)
    assert gk.geometry_replay.launches == geo + 4 and rk.replay_persistent.launches == rep + 4
    for n, r in ref.items():
        field = [m for m in ref if m.split(".")[0] == n.split(".")[0]]
        scale = max(float(ref[m].abs().max()) for m in field)
        assert float((got[n] - r).abs().max()) <= 1e-3 * scale, n
    big = tp.get_scene("random_spheres", 32, 24).to(cuda)
    assert grad.backward_route(big, cfg, fields) == "scan"
    geo = gk.geometry_replay.launches
    grads(big)
    assert gk.geometry_replay.launches == geo


@pytest.mark.parametrize("name,dtype,jitter", [("random_spheres", torch.float32, "uniform"),
                                               ("box", torch.float64, "uniform"),
                                               ("box", torch.float32, "tent")])
def test_replay_backward_takes_the_plain_replay_on_the_card(cuda, name, dtype, jitter):
    """A CUDA scene the replay kernel does not take gets the plain replay on
    the card: no replay kernel launch, albedo and emission gradients within
    1e-9 (float64) or 1e-3 (float32) of each field's largest magnitude of
    the CPU's."""
    from cpu_path_tracing_tpu_torch.ops.replay import replay_route

    cfg = tp.RenderConfig(width=16, height=12, spp=2, max_depth=100, jitter=jitter)
    ref = _leaf_grads(tp.get_scene(name, 16, 12, dtype=dtype), cfg, ("albedo", "emission"))
    scene = tp.get_scene(name, 16, 12, dtype=dtype).to(cuda)
    assert replay_route(scene, cfg) == "plain"
    rep = rk.replay_persistent.launches
    got = _leaf_grads(scene, cfg, ("albedo", "emission"))
    assert rk.replay_persistent.launches == rep
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    for n, r in ref.items():
        assert float((got[n] - r).abs().max()) <= tol * float(r.abs().max()), n


@pytest.mark.parametrize("n_arrays", [2, 8])
@pytest.mark.parametrize("op", sorted(pk.OPS))
def test_op_chain_kernel_matches_plain_version(cuda, op, n_arrays):
    """Every probe op at n = 64*128, 16 iterations and its own count: the
    uint32 ops bitwise (int64 words and int32 bits), mul-add, add and select
    bitwise, the fused multiply-add within 1 ulp, sin, sqrt and 1/sqrt
    within 2 ulp."""
    rng, spec = np.random.default_rng(5), pk.OPS[op]
    limit = {"fma": 1, "sin": 2, "sqrt": 2, "rsqrt": 2}.get(op, 0)
    for iters in (16, spec.iters):
        before = pk.op_chain.launches
        if spec.words:
            xs = torch.from_numpy(rng.integers(0, 2**32, (n_arrays, 8192), dtype=np.int64)).to(cuda)
            ref = pk.op_chain_reference(xs, op, iters)
            assert torch.equal(pk.op_chain(xs, op, iters), ref)
            bits = pk.op_chain(rng_ops.int32_bits(xs), op, iters)
            assert bits.dtype == torch.int32 and torch.equal(rng_ops.words_from_int32(bits), ref)
            assert pk.op_chain.launches == before + 2
        else:
            xs = torch.from_numpy(rng.uniform(0.25, 1.5, (n_arrays, 8192)).astype(np.float32))
            xs = xs.to(cuda)
            got, ref = pk.op_chain(xs, op, iters), pk.op_chain_reference(xs, op, iters)
            ulps = (got.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max()
            assert bool(torch.isfinite(got).all()) and int(ulps) <= limit
            assert pk.op_chain.launches == before + 1


# One tile of the stream kernel: 512 threads x one float4 (csrc/probe.cu).
STREAM_TILE = 512 * 4


@pytest.mark.parametrize("n", [1, 3, 4, STREAM_TILE - 1, STREAM_TILE, STREAM_TILE + 1,
                               1 << 16, (1 << 16) + 3, (1 << 20) + 3, 1 << 26])
def test_stream_kernel_matches_plain_version(cuda, n):
    """Bitwise at sizes below a float4, around one tile, with a ragged end
    and at the probe's own 2^26."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(n, dtype=np.float32)).to(cuda)
    before = pk.stream_scale.launches
    got = pk.stream_scale(x)
    assert got.shape == x.shape and torch.equal(got, pk.stream_scale_reference(x))
    assert pk.stream_scale.launches == before + 1


def test_probe_wrappers_reject_what_the_kernels_do_not_take(cuda):
    xs = torch.ones((8, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pk.op_chain(xs.T.contiguous().T, "add", 1)
    with pytest.raises(ValueError, match="contiguous"):
        pk.stream_scale(xs[:, ::2])
    with pytest.raises(ValueError, match="aligned"):
        pk.stream_scale(torch.ones(65, device=cuda)[1:])


def test_tiled_render_is_the_one_pass_image_on_the_card(cuda, tmp_path):
    """Every tile one launch of the whole-render kernel, a retried tile the
    same bits, the image the one-pass render's bitwise; a resumed run
    launches only the missing tiles."""
    from cpu_path_tracing_tpu_torch.orchestrator import (
        FaultInjector, TileRenderError, render_tiled, tile_spans)

    cfg = tp.RenderConfig(width=64, height=48, spp=2, max_depth=100)
    scene = tp.get_scene("box_mirror", 64, 48).to(cuda)
    ref = tp.render_image(scene, cfg)
    n_tiles = len(tile_spans(cfg, 3000)[0])
    before = mk.persistent_render.launches
    img = render_tiled(scene, cfg, tile_cells=3000, fault_injector=FaultInjector({1: 2}))
    assert mk.persistent_render.launches - before == n_tiles
    assert img.device.type == "cuda" and torch.equal(img, ref)
    ck = str(tmp_path / "tiles.npz")
    with pytest.raises(TileRenderError):
        render_tiled(scene, cfg, tile_cells=3000, checkpoint_path=ck, max_retries=0,
                     fault_injector=FaultInjector({2: 1}))
    before = mk.persistent_render.launches
    assert torch.equal(render_tiled(scene, cfg, tile_cells=3000, checkpoint_path=ck), ref)
    assert mk.persistent_render.launches - before == n_tiles - 2


def test_progressive_resume_is_bitwise_on_the_card(cuda, tmp_path):
    from cpu_path_tracing_tpu_torch.utils.checkpoint import render_progressive

    cfg = tp.RenderConfig(width=64, height=48, spp=4, max_depth=100)
    scene = tp.get_scene("box_mirror", 64, 48).to(cuda)
    ck = str(tmp_path / "ck.npz")
    render_progressive(scene, cfg.replace(spp=2), ck, flush_every=1)
    before = mk.persistent_render.launches
    resumed = render_progressive(scene, cfg, ck, flush_every=1)
    assert mk.persistent_render.launches - before == 2
    assert torch.equal(resumed, render_progressive(scene, cfg, flush_every=1))
    torch.testing.assert_close(resumed, tp.render_image(scene, cfg), rtol=1e-6, atol=1e-6)


def test_invert_resume_is_bitwise_on_the_card(cuda):
    """Adam's counter stays on the host and its moments on the card across
    a save and load, and the resumed steps repeat the straight ones."""
    from cpu_path_tracing_tpu_torch import grad

    cfg = tp.RenderConfig(width=64, height=48, spp=2, max_depth=100)
    scene = tp.get_scene("box", 64, 48).to(cuda)
    target = grad.render_target(scene, cfg)
    p0 = {k: v + 0.02 for k, v in grad.split_params(scene, ("albedo", "emission")).items()}
    straight = grad.make_accum_train_step(scene, cfg, 1e-2, cell_chunk=4096)
    p = p0
    for _ in range(4):
        p, _ = straight(p, target)
    first = grad.make_accum_train_step(scene, cfg, 1e-2, cell_chunk=4096)
    q = p0
    for _ in range(2):
        q, _ = first(q, target)
    sd = first.state_dict()
    resumed = grad.make_accum_train_step(scene, cfg, 1e-2, cell_chunk=4096)
    resumed.load_state_dict(sd)
    before = rk.replay_persistent.launches
    for _ in range(2):
        q, _ = resumed(q, target)
    assert rk.replay_persistent.launches - before == 2 * -(-cfg.num_cells // 4096)
    for k in p:
        assert torch.equal(p[k], q[k]), k
    a, b = straight.state_dict()["optimizer"]["state"], resumed.state_dict()["optimizer"]["state"]
    for i in a:
        assert b[i]["step"].device.type == "cpu" and b[i]["exp_avg"].device.type == "cuda"
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[i][key], b[i][key]), (i, key)


def test_nan_guard_keeps_the_kernels_on_the_card(cuda):
    from cpu_path_tracing_tpu_torch import grad, render
    from cpu_path_tracing_tpu_torch.utils.debug import debug_context

    cfg = tp.RenderConfig(width=64, height=48, spp=2, max_depth=100)
    scene = tp.get_scene("box", 64, 48).to(cuda)
    ids = torch.arange(cfg.num_cells, device=cuda)
    k2, k3 = mk.persistent_render.launches, rk.replay_persistent.launches
    with debug_context(nans=True):
        render.render_cells_range(scene, cfg, ids, 0, 2)
        step = grad.make_accum_train_step(scene, cfg, 1e-2)
        p = {k: v + 0.02 for k, v in grad.split_params(scene, ("albedo", "emission")).items()}
        step(p, grad.render_target(scene, cfg))
    assert mk.persistent_render.launches > k2 and rk.replay_persistent.launches > k3
    scene.emission[7] = float("nan")
    with pytest.raises(FloatingPointError):
        with debug_context(nans=True):
            render.render_cells_range(scene, cfg, ids, 0, 2)


def test_tiles_mesh_render_is_the_one_pass_image_on_the_card(cuda):
    """A 4x1 mesh on one card: 4 launches of the forward kernel, the image
    bitwise equal to render_image's one pass."""
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh
    from cpu_path_tracing_tpu_torch.parallel.render import render_image_sharded

    cfg = tp.RenderConfig(width=256, height=192, spp=8, max_depth=100)
    scene = tp.get_scene("box_mirror", cfg.width, cfg.height).to(cuda)
    ref = tp.render_image(scene, cfg)
    k2 = mk.persistent_render.launches
    img = render_image_sharded(scene, cfg, make_mesh(4, 1, [cuda] * 4))
    assert mk.persistent_render.launches - k2 == 4
    assert img.device.type == "cuda" and torch.equal(img, ref)


def test_sharded_accum_step_gradients_match_one_device_on_the_card(cuda):
    """One 2x2 sharded loss-and-gradient on one card against the one-device
    one: both the forward and the replay kernel, 4 launches each a chunk;
    float32 sums re-associated, so the loss within 1e-5 relative and each
    leaf within 1e-5 of its largest |gradient|."""
    from cpu_path_tracing_tpu_torch import grad
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh

    cfg = tp.RenderConfig(width=64, height=64, spp=8, max_depth=100)
    scene = tp.get_scene("box", cfg.width, cfg.height).to(cuda)
    target = grad.render_target(scene, cfg)
    params = {k: v + 0.02 for k, v in grad.split_params(scene, ("albedo", "emission")).items()}
    loss, g = grad.make_accum_loss_grad(scene, cfg, cell_chunk=4096)(params, target)
    k2, k3 = mk.persistent_render.launches, rk.replay_persistent.launches
    sharded = grad.make_sharded_accum_loss_grad(make_mesh(2, 2, [cuda] * 4), scene, cfg,
                                                cell_chunk=4096)
    loss2, g2 = sharded(params, target)
    chunks = -(-cfg.num_cells // 4096)
    assert mk.persistent_render.launches - k2 == 4 * chunks
    assert rk.replay_persistent.launches - k3 == 4 * chunks
    assert abs(float(loss2) - float(loss)) <= 1e-5 * float(loss)
    for k in g:
        assert g2[k].device.type == "cuda"
        assert float((g2[k] - g[k]).abs().max()) <= 1e-5 * float(g[k].abs().max()), k


def test_spmd_mesh_render_equals_the_serial_order_on_the_card(cuda):
    """The 2x2 mesh of one card through the SPMD runner (a worker and a
    stream a shard) against the same shards run one after another on the
    current stream, bitwise."""
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh
    from cpu_path_tracing_tpu_torch.parallel.render import (render_cells_sharded, sum_shards,
                                                            tile_span)
    from cpu_path_tracing_tpu_torch.render import render_cells_range

    cfg = tp.RenderConfig(width=96, height=64, spp=4, max_depth=100)
    scene = tp.get_scene("box_mirror", cfg.width, cfg.height).to(cuda)
    got = render_cells_sharded(scene, cfg, make_mesh(2, 2, [cuda] * 4))
    per = tile_span(cfg, 2)
    ref = []
    for t in range(2):
        ids = torch.arange(t * per, (t + 1) * per, dtype=torch.int64, device=cuda)
        parts = [render_cells_range(scene, cfg, ids, 2 * s, 2) for s in range(2)]
        ref.append((sum_shards(parts, cuda) / cfg.spp)[:cfg.num_cells - t * per])
    assert torch.equal(got, torch.cat(ref))



def test_spmd_runs_each_entry_on_its_own_stream(cuda):
    """Every entry of a 2x2 mesh of one card runs on a stream of its own,
    not the caller's; the four 10 ms waits of one thread each overlap on the
    card (all four in well under twice one of them)."""
    from cpu_path_tracing_tpu_torch.parallel import spmd
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh

    cycles = int(torch.cuda.get_device_properties(cuda).clock_rate * 1e3 * 0.01)  # ~10 ms
    mesh = make_mesh(2, 2, [cuda] * 4)
    caller = torch.cuda.current_stream(cuda).cuda_stream

    def shard(t, s, d):
        torch.cuda._sleep(cycles)
        return torch.cuda.current_stream(d).cuda_stream

    spmd.run(mesh, shard)  # warm-up
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = spmd.run(mesh, shard)
    b.record()
    torch.cuda.synchronize()
    ids = [x for row in out for x in row]
    assert len(set(ids)) == 4 and caller not in ids
    one = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    one[0].record()
    torch.cuda._sleep(cycles)
    one[1].record()
    torch.cuda.synchronize()
    assert a.elapsed_time(b) < 2 * one[0].elapsed_time(one[1])


def test_spmd_hands_work_over_by_the_streams(cuda):
    """What the caller enqueued before the call is ready when an entry reads
    it, and an entry's result is ready when the caller reads it, with no
    synchronize in between: each side's write sits behind a 20 ms wait."""
    from cpu_path_tracing_tpu_torch.parallel import spmd
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh

    cycles = int(torch.cuda.get_device_properties(cuda).clock_rate * 1e3 * 0.02)
    n = 1 << 22
    torch.cuda._sleep(cycles)
    y = torch.full((n,), 3.0, device=cuda)

    def shard(t, s, d):
        got = (y * 2).sum()
        torch.cuda._sleep(cycles)
        return got, torch.full((n,), float(t + s), device=d)

    out = spmd.run(make_mesh(2, 2, [cuda] * 4), shard)
    assert [float(g) for row in out for g, _ in row] == [6.0 * n] * 4
    assert [float(x.sum()) for row in out for _, x in row] == [0.0, n, n, 2.0 * n]


def test_spmd_shard_error_reaches_the_caller_on_the_card(cuda):
    """A shard that raises on the card fails the call, naming its entry;
    the next call on the same mesh runs."""
    from cpu_path_tracing_tpu_torch.parallel import spmd
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2, [cuda] * 4)

    def shard(t, s, d):
        x = torch.full((1 << 20,), float(2 * t + s), device=d)
        if (t, s) == (1, 0):
            raise RuntimeError("shard failed")
        return x.sum()

    with pytest.raises(RuntimeError, match="shard failed") as info:
        spmd.run(mesh, shard)
    assert any("in mesh entry (1, 0)" in note for note in info.value.__notes__)
    out = spmd.run(mesh, lambda t, s, d: torch.full((1 << 20,), float(2 * t + s), device=d).sum())
    assert [float(x) for row in out for x in row] == [float(i << 20) for i in range(4)]


def test_accum_step_over_cards_equals_the_one_card_mesh(cuda):
    """A 2x2 mesh over two cards (a worker process a card,
    ``parallel/cards.py``) gives the same mesh shape's loss and gradients on
    one card, bitwise: the same kernels and the same order of every sum."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from cpu_path_tracing_tpu_torch import grad
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh

    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    cfg = tp.RenderConfig(width=64, height=64, spp=8, max_depth=100)
    scene = tp.get_scene("box", cfg.width, cfg.height).to(c0)
    target = grad.render_target(scene, cfg)
    params = {k: v + 0.02 for k, v in grad.split_params(scene, ("albedo", "emission")).items()}
    one = grad.make_sharded_accum_loss_grad(make_mesh(2, 2, [c0] * 4), scene, cfg,
                                            cell_chunk=4096)(params, target)
    cards = grad.make_sharded_accum_loss_grad(make_mesh(2, 2, [c0, c0, c1, c1]), scene, cfg,
                                              cell_chunk=4096)
    try:
        for _ in range(2):
            loss, g = cards(params, target)
            assert loss.device == c0 and torch.equal(loss, one[0])
            assert all(torch.equal(g[k], one[1][k]) for k in g)
    finally:
        cards.close()


def _bench_readers():
    """``port_bench``'s configurations, traffic and span readers
    (``port_bench/harness``), importable as the benchmark imports them."""
    import sys
    from pathlib import Path

    bench = str(Path(__file__).resolve().parents[1] / "port_bench")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness import port, spans, trace
    from harness.spec import Cell

    return Cell, port, spans, trace


@pytest.mark.parametrize("cell", ["box_400x400.geometry", "box_400x400.invert",
                                  "disco_1024x768.preview"])
def test_a_step_or_an_image_reads_nothing_back_on_the_card(cuda, cell):
    """The benchmark's cells, one step or image traced after a warm-up: the
    benchmark's own reader counts no blocking call of the CUDA runtime
    inside ``pt.step`` or ``pt.render_image``, and no ``pt.cells.readback``
    span is entered, while every wrapper of the route ran."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from cpu_path_tracing_tpu_torch import grad

    Cell, port, spans, trace = _bench_readers()
    c = Cell(cell)
    scene = port.scene(c.config, cuda)
    if "fields" in c.traffic:
        unit, wrappers = "step", {"pt.k2", "pt.k3"} | ({"pt.k7"} if "p0" in
                                                        c.traffic["fields"] else set())
        cfg = port.render_config(c.config, c.config["spp"], 11)
        target = grad.render_target(scene, cfg, c.config["cell_chunk"])
        step = grad.make_accum_train_step(scene, cfg, c.config["lr"],
                                          cell_chunk=c.config["cell_chunk"],
                                          sample_chunk=c.config["sample_chunk"])
        params = {k: v + c.traffic["offset"]
                  for k, v in grad.split_params(scene, tuple(c.traffic["fields"])).items()}

        def run():
            return float(step(params, target)[1])
    else:
        unit, wrappers = "image", {"pt.k2"}
        cfg = port.render_config(c.config, c.traffic["total_spp"] // 4, 11)

        def run():
            return tp.render_image(scene, cfg)

    run()
    torch.cuda.synchronize(cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("test.window"):
            run()
            torch.cuda.synchronize(cuda)
    tr = trace.from_profile(prof, "test.window")
    names = {n for n, _, _ in tr.host}
    assert wrappers <= names and "pt.cells.readback" not in names
    got = spans.syncs_per_unit(SimpleNamespace(unit=unit, trace=tr, n_profiled=1), unit)
    assert got is not None and got["value"] == 0, got["note"]
