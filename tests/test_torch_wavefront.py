"""The port's wavefront loop and the integrator dispatch, against the JAX package.

* ``render_wavefront`` in float64 against the JAX package's XLA
  ``render_wavefront`` (``conftest.py`` enables x64) on the same (scene,
  config, seed): both draw bit-identical uniforms and run the same
  expressions, so per-cell sums agree to float64 rounding (1e-12
  relative), and the segment counts and retirement histograms are equal.
* Lane-count invariance, sample-range splits, the contiguity rule and the
  histogram identities of the JAX ``tests/test_wavefront.py``.
* ``resolve_integrator`` and ``render_cells_range``'s routes, with the
  routes monkeypatched (JAX ``tests/test_wavefront.py:175-194``); a CUDA
  scene is stood in for by patching the device check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.ops.wavefront import render_wavefront as jax_render_wavefront
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import render
from cpu_path_tracing_tpu_torch.ops import wavefront

torch.set_num_threads(1)

W, H = 12, 8


def _ids(cfg):
    return torch.arange(cfg.num_cells)


@pytest.mark.parametrize("name", ["simple", "box", "box_mirror", "smallpt"])
def test_render_wavefront_f64_matches_jax(name):
    jcfg = pt.RenderConfig(width=W, height=H, spp=2, max_depth=16)
    tcfg = tp.RenderConfig(width=W, height=H, spp=2, max_depth=16)
    ref, jst = jax_render_wavefront(pt.get_scene(name, W, H, dtype=jnp.float64), jcfg,
                                    jnp.arange(jcfg.num_cells), 0, 2, lanes=256,
                                    with_stats=True, depth_hist=True)
    got, st = wavefront.render_wavefront(tp.get_scene(name, W, H, dtype=torch.float64), tcfg,
                                         _ids(tcfg), 0, 2, lanes=256, with_stats=True,
                                         depth_hist=True)
    assert got.dtype == torch.float64 and got.shape == (tcfg.num_cells, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    assert st["segments"] == int(jst["segments"]) > 0
    np.testing.assert_array_equal(st["depth_hist"].numpy(), np.asarray(jst["depth_hist"]))
    assert st["lanes"] == 256


@pytest.mark.parametrize("lanes", [3, 100, 10**9])
def test_lane_count_invariance(lanes):
    """Any pool width gives the per-item radiance of the batch plain
    version, so the sums are bitwise equal."""
    cfg = tp.RenderConfig(width=4, height=3, spp=2, max_depth=12)
    scene = tp.get_scene("box", 4, 3, dtype=torch.float64)
    got, st = wavefront.render_wavefront(scene, cfg, _ids(cfg), 0, 2, lanes=lanes,
                                         with_stats=True)
    ref, ref_st = wavefront.render_wavefront_persistent(scene, cfg, _ids(cfg), 0, 2,
                                                        with_stats=True)
    assert torch.equal(got, ref)
    assert st["segments"] == ref_st["segments"]
    assert st["lanes"] == min(lanes, 2 * cfg.num_cells)


def test_sample_range_split():
    cfg = tp.RenderConfig(width=8, height=6, spp=4, max_depth=12)
    scene = tp.get_scene("box", 8, 6, dtype=torch.float64)
    full = wavefront.render_wavefront(scene, cfg, _ids(cfg), 0, 4, lanes=64)
    a = wavefront.render_wavefront(scene, cfg, _ids(cfg), 0, 2, lanes=64)
    b = wavefront.render_wavefront(scene, cfg, _ids(cfg), 2, 2, lanes=64)
    torch.testing.assert_close(a + b, full, rtol=1e-12, atol=1e-12)


def test_noncontiguous_cells_rejected():
    cfg = tp.RenderConfig(width=W, height=H, spp=1, max_depth=4)
    scene = tp.get_scene("simple", W, H)
    bad = torch.tensor([0, 2, 4, 6])
    with pytest.raises(ValueError, match="contiguous"):
        wavefront.render_wavefront(scene, cfg, bad, 0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wavefront.render_wavefront_per_step(scene, cfg, bad, 0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        render.render_cells_range(scene, cfg.replace(integrator="wavefront"), bad, 0, 1)


def test_observability_stats():
    """Segments == histogram mass weighted by depth, histogram mass == item
    count, occupancy in (0, 1]."""
    cfg = tp.RenderConfig(width=W, height=H, spp=2, max_depth=24)
    scene = tp.get_scene("box", W, H)
    _, stats = wavefront.render_wavefront(scene, cfg, _ids(cfg), 0, 2, with_stats=True,
                                          depth_hist=True, lanes=256)
    hist = stats["depth_hist"].numpy()
    assert hist.shape == (cfg.max_depth,) and hist.sum() == cfg.num_cells * 2
    assert (hist * np.arange(1, cfg.max_depth + 1)).sum() == stats["segments"]
    assert 0.0 < stats["segments"] / (stats["iters"] * stats["lanes"]) <= 1.0


def test_loop_raises_when_the_pool_does_not_drain(monkeypatch):
    """The loop stops with an error, never with a silently truncated
    render, at the end of the batch that reaches its hard cap of n_gens *
    max_depth + 1 steps (batches of STEP_BATCH launches of STEPS_PER_LAUNCH
    steps)."""
    cfg = tp.RenderConfig(width=4, height=3, spp=1, max_depth=5)
    for per_launch, batches in ((1, 4), (2, 2), (4, 1)):
        monkeypatch.setattr(wavefront, "STEPS_PER_LAUNCH", per_launch)
        launches = []

        def never_drains(state, table, cam, dyn, *, seg, seg_slot, steps, **kw):
            launches.append((seg_slot, steps))
            seg[seg_slot:seg_slot + steps] += 1

        with pytest.raises(RuntimeError, match="did not drain in 61 steps"):
            wavefront.drive_items(never_drains, tp.get_scene("box", 4, 3), cfg, _ids(cfg), 0, 1,
                                  4)
        batch = [(b * per_launch, per_launch) for b in range(wavefront.STEP_BATCH)]
        assert launches == batch * batches
        assert len(launches) * per_launch >= 61 > (len(launches) - len(batch)) * per_launch


@pytest.mark.parametrize("per_launch", [1, 2, 4])
def test_steps_per_launch_invariance(monkeypatch, per_launch):
    """The steps a launch runs change the schedule of launches, not the
    render: the same sums, segments, iters and retirement histogram, over
    a pool that regenerates (5 generations)."""
    cfg = tp.RenderConfig(width=W, height=H, spp=2, max_depth=16)
    scene = tp.get_scene("box_mirror", W, H)

    def render(fn, **kw):
        return fn(scene, cfg, _ids(cfg), 0, 2, lanes=40, with_stats=True, **kw)

    monkeypatch.setattr(wavefront, "STEPS_PER_LAUNCH", 1)
    ref, ref_st = render(wavefront.render_wavefront, depth_hist=True)
    monkeypatch.setattr(wavefront, "STEPS_PER_LAUNCH", per_launch)
    got, st = render(wavefront.render_wavefront, depth_hist=True)
    assert torch.equal(got, ref)
    assert st["segments"] == ref_st["segments"] > 0 and st["iters"] == ref_st["iters"] > 16
    assert torch.equal(st["depth_hist"], ref_st["depth_hist"])
    per_step, per_step_st = render(wavefront.render_wavefront_per_step)
    assert torch.equal(per_step, ref)
    assert per_step_st == {k: ref_st[k] for k in ("segments", "iters", "lanes")}


def test_cpu_loop_never_captures_a_graph(monkeypatch):
    """A CUDA graph is for the card only: on a CPU scene the per-step loop
    calls ``megakernel_step`` launch by launch, a batch of STEP_BATCH calls
    between two reads of the counts."""
    def no_graph(*args, **kw):
        raise AssertionError("the CPU loop asked for a captured batch")

    calls = []
    real = wavefront.megakernel_step

    def counted(*args, **kw):
        calls.append((kw["seg_slot"], kw["steps"]))
        real(*args, **kw)

    monkeypatch.setattr(wavefront, "megakernel_step_batch", no_graph)
    monkeypatch.setattr(wavefront, "megakernel_step", counted)
    cfg = tp.RenderConfig(width=4, height=3, spp=1, max_depth=6)
    out, st = wavefront.drive_items(counted, tp.get_scene("box", 4, 3), cfg, _ids(cfg), 0, 1)
    S = wavefront.STEPS_PER_LAUNCH
    assert len(calls) % wavefront.STEP_BATCH == 0 and len(calls) * S >= st["iters"] > 0
    assert calls[:wavefront.STEP_BATCH] == [(b * S, S) for b in range(wavefront.STEP_BATCH)]
    assert bool(torch.isfinite(out).all())


def test_integrator_dispatch(monkeypatch):
    """'wavefront' -> render_wavefront; 'pallas' -> the whole-render kernel,
    with pallas_persistent=False the per-step kernel; 'auto' on the CPU ->
    the whole-render kernel's plain version; 'batch', and loop='scan' with
    any integrator, -> the batch route.  Routing only."""
    calls = []
    for route, fn in (("wavefront", "render_wavefront"), ("persistent",
                      "render_wavefront_persistent"), ("per-step", "render_wavefront_per_step"),
                      ("batch", "render_batch")):
        monkeypatch.setattr(render, fn, lambda *a, route=route, **k: calls.append(route) or a[2])
    cfg = tp.RenderConfig(width=8, height=6, spp=1, max_depth=8)
    scene = tp.get_scene("box", 8, 6)
    for integ, persistent in (("wavefront", True), ("pallas", True), ("pallas", False),
                              ("auto", True), ("auto", False)):
        render.render_cells_range(scene, cfg.replace(integrator=integ,
                                                     pallas_persistent=persistent),
                                  _ids(cfg), 0, 1)
    assert calls == ["wavefront", "persistent", "per-step", "persistent", "persistent"]
    calls.clear()
    for integ in ("batch", "auto", "pallas", "wavefront"):
        render.render_cells_range(scene, cfg.replace(integrator=integ, loop="scan"), _ids(cfg),
                                  0, 1)
    render.render_cells_range(scene, cfg.replace(integrator="batch"), _ids(cfg), 0, 1)
    assert calls == ["batch"] * 5
    with pytest.raises(ValueError, match="unknown loop"):
        render.resolve_integrator(scene, cfg.replace(loop="fori"))
    with pytest.raises(ValueError, match="unknown integrator"):
        render.resolve_integrator(scene, cfg.replace(integrator="xla"))


@pytest.mark.parametrize("dtype,jitter,integ,want", [
    (torch.float32, "uniform", "auto", "pallas"),
    (torch.float64, "uniform", "auto", "wavefront"),
    (torch.float32, "tent", "auto", "wavefront"),
    (torch.float64, "tent", "wavefront", "wavefront"),
    (torch.float32, "uniform", "pallas", "pallas"),
])
def test_resolve_integrator_on_cuda(monkeypatch, dtype, jitter, integ, want):
    """On a CUDA scene 'auto' picks the kernels for float32 with uniform
    jitter and the plain wavefront loop otherwise (JAX render.py:107-119)."""
    monkeypatch.setattr(render, "_on_cuda", lambda scene: True)
    scene = tp.get_scene("box", 8, 6, dtype=dtype)
    cfg = tp.RenderConfig(width=8, height=6, jitter=jitter, integrator=integ)
    assert render.resolve_integrator(scene, cfg) == want


@pytest.mark.parametrize("on_cuda", [True, False])
def test_pallas_with_tent_or_float64_raises(monkeypatch, on_cuda):
    """integrator='pallas' names the float32, uniform-jitter kernels: tent
    jitter and float64 raise before anything runs, as in JAX."""
    monkeypatch.setattr(render, "_on_cuda", lambda scene: on_cuda)
    cfg = tp.RenderConfig(width=8, height=6, integrator="pallas")
    with pytest.raises(ValueError, match="tent.*integrator='wavefront'"):
        render.resolve_integrator(tp.get_scene("box", 8, 6), cfg.replace(jitter="tent"))
    with pytest.raises(ValueError, match="float32.*integrator='wavefront'"):
        render.resolve_integrator(tp.get_scene("box", 8, 6, dtype=torch.float64), cfg)


def test_render_image_through_each_route_agrees():
    """render_image by the three routes on the CPU: the same image, bitwise
    (per-item radiance does not depend on the route's schedule)."""
    cfg = tp.RenderConfig(width=8, height=6, spp=2, max_depth=10, wavefront_lanes=50)
    scene = tp.get_scene("box_mirror", 8, 6)
    ref = tp.render_image(scene, cfg)
    for change in (dict(integrator="wavefront"), dict(integrator="pallas"),
                   dict(integrator="pallas", pallas_persistent=False)):
        assert torch.equal(tp.render_image(scene, cfg.replace(**change)), ref), change
