"""The per-step kernel module: its plain version against the TPU kernel, the
wrapper, the per-step loop and ``cli bench``.

``megakernel_step_reference`` (the plain PyTorch version of the CUDA
per-step kernel) is held to the JAX package's Pallas ``megakernel_step``
run in interpret mode on the CPU, step by step from the same initial
state, with the JAX state carried into the port's layout by
``lane_state_from_arrays``.  The JAX kernel's ring holds K=4 >= n_gens=2
generations, so its ``g_flush + K`` gate never holds a lane back and both
schedules coincide.  Then the whole per-step loop against the JAX
``render_wavefront_pallas`` (interpret mode), whose schedule differs but
whose per-item radiance does not.  Float32 sqrt/rsqrt/sin/cos differ by
an ulp between XLA and PyTorch on the CPU, so radiance agrees within 1e-5
scale-aware on >= 99.9% of items (or cells), integers exactly, and segment
counts of the whole render within 0.1%.  The path state itself (hit points,
directions) carries the float32 intersect's conditioning, which turns
those ulps into more: measured on simple, box and box_mirror over three
steps, 2-8% of lanes above 1e-5 and all but one of 1024 within 1e-3 (at
most 1.25e-3), every integer field equal.  So the state's floats are held
within 1e-5 on >= 90% of lanes and within 1e-3 on >= 99.9%.  (The CUDA
kernel itself is held
to the plain version and to the whole-render kernel on the card:
tests/test_torch_cuda.py and chip_smoke.py.)
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.ops.pallas import megakernel as jmk
from cpu_path_tracing_tpu.ops.wavefront import render_wavefront_pallas
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import cli
from cpu_path_tracing_tpu_torch.ops import wavefront
from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk
from cpu_path_tracing_tpu_torch.utils.parity import scale_aware

torch.set_num_threads(1)

W, H, SPP, DEPTH, LANES, ROWS, RING = 16, 12, 2, 8, 1024, 8, 4


def _close_share(a, b, tol: float = 1e-5) -> float:
    """Share of lanes (last axis) whose worst field is within ``tol``."""
    return float(np.mean(scale_aware(a, b).max(axis=0) < tol))


def test_plain_step_matches_pallas_kernel():
    jcfg = pt.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    tcfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    # An open scene, so that paths finish (sky misses) within three steps.
    scene = pt.get_scene("simple", W, H, dtype=jnp.float32)
    table = np.array(jmk.pack_scene(scene))  # writable copies for torch.from_numpy
    cam = np.array(jmk.pack_camera(scene))
    n_cells = tcfg.num_cells
    n_items = n_cells * SPP
    n_gens = -(-n_items // LANES)
    assert n_items > LANES and n_gens <= RING

    rows = LANES // jmk.LANE
    izero = jnp.zeros((rows, jmk.LANE), jnp.int32)
    jstate = {n: izero.astype(jnp.float32) for n in jmk.F32_STATE}
    jstate.update({n: izero for n in jmk.I32_STATE})
    jstate["gen"] = izero - 1
    jstate.update({n: izero.astype(jnp.uint32) for n in jmk.U32_STATE})
    ring = {n: jnp.zeros((RING, rows, jmk.LANE), jnp.float32) for n in jmk.RING_NAMES}
    kw = dict(cfg=jcfg, n_spheres=table.shape[0], n_cells=n_cells, n_items=n_items,
              n_gens=n_gens, lanes=LANES, ring_depth=RING, rows=ROWS, interpret=True,
              ior=scene.ior)

    state = mk.init_lane_state(LANES, "cpu")
    out = torch.zeros((3, n_items))
    seg = torch.zeros(3, dtype=torch.int64)
    ttable, tcam = torch.from_numpy(table), torch.from_numpy(cam)
    for step in range(3):
        jstate, ring, nseg = jmk.megakernel_step(jstate, ring, jnp.asarray(table),
                                                 jnp.asarray(cam), jnp.zeros(3, jnp.int32),
                                                 **kw)
        mk.megakernel_step_reference(state, ttable, tcam, (0, 0), cfg=tcfg, n_cells=n_cells,
                                     n_items=n_items, lanes=LANES, out=out, seg=seg,
                                     seg_slot=step, ior=scene.ior)
        ref = mk.lane_state_from_arrays({n: np.asarray(v) for n, v in jstate.items()})
        assert torch.equal(state.i, ref.i), step
        assert _close_share(state.f.numpy(), ref.f.numpy()) >= 0.9, step
        assert _close_share(state.f.numpy(), ref.f.numpy(), 1e-3) >= 0.999, step
        assert int(seg[step]) == int(nseg) > 0

    # Retired paths: the JAX ring slot gen % K holds generation gen.
    got = out.numpy().reshape(3, -1)
    jring = np.stack([np.asarray(ring[n]).reshape(RING, LANES) for n in jmk.RING_NAMES])
    ref = np.zeros_like(got)
    for g in range(n_gens):
        m = min(LANES, n_items - g * LANES)
        ref[:, g * LANES:g * LANES + m] = jring[:, g % RING, :m]
    assert np.count_nonzero(ref) > 0
    assert _close_share(got, ref) >= 0.999


def test_per_step_loop_matches_pallas_render():
    """The per-step loop on the CPU (the plain step) against the JAX
    per-step render in interpret mode, at test_wavefront.py's fast-tier
    sizes."""
    jcfg = pt.RenderConfig(width=12, height=8, spp=1, max_depth=8)
    tcfg = tp.RenderConfig(width=12, height=8, spp=1, max_depth=8)
    ref, jst = render_wavefront_pallas(
        pt.get_scene("box_mirror", 12, 8, dtype=jnp.float32), jcfg,
        jnp.arange(jcfg.num_cells, dtype=jnp.int32), 0, 1, lanes=1024, rows=8, ring_depth=4,
        interpret=True, with_stats=True)
    got, st = wavefront.render_wavefront_per_step(tp.get_scene("box_mirror", 12, 8), tcfg,
                                                  torch.arange(tcfg.num_cells), 0, 1,
                                                  lanes=1024, with_stats=True)
    assert got.dtype == torch.float32 and got.shape == (tcfg.num_cells, 3)
    assert _close_share(got.numpy().T, np.asarray(ref).T) >= 0.999
    assert abs(st["segments"] - int(jst["segments"])) <= 1e-3 * int(jst["segments"])
    assert st["lanes"] == tcfg.num_cells and 0 < st["iters"] <= tcfg.max_depth


def _step_args(cfg, scene, lanes):
    n_items = cfg.num_cells * cfg.spp
    state = mk.init_lane_state(lanes, "cpu")
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=n_items, lanes=lanes,
              out=torch.zeros((3, n_items)), seg=torch.zeros(4, dtype=torch.int64), seg_slot=0,
              ior=scene.ior)
    return state, (mk.pack_scene(scene), mk.pack_camera(scene), (0, 0)), kw


@pytest.mark.parametrize("steps", [2, 4])
def test_reference_with_steps_equals_single_steps(steps):
    """One call of S steps is S calls of one step, bitwise in the state,
    ``out`` and every ``seg`` slot: from a mid-render state (live lanes,
    lanes that regenerate inside the call, 3 generations) to past the
    drain, where further steps add 0 and write nothing."""
    cfg = tp.RenderConfig(width=8, height=6, spp=2, max_depth=6)
    scene = tp.get_scene("simple", 8, 6)
    lanes, calls = 160, 12
    n_gens = -(-cfg.num_cells * cfg.spp // lanes)
    assert n_gens == 3
    a, args, kw = _step_args(cfg, scene, lanes)
    kw["seg"] = torch.zeros(3 + calls * steps, dtype=torch.int64)
    for slot in range(3):  # to mid-render, one step at a time
        mk.megakernel_step_reference(a, *args, **dict(kw, seg_slot=slot))
    assert 0 < int((a.i[4] != 0).sum()) and int(a.i[3].max()) < n_gens - 1
    b = mk.LaneState(a.f.clone(), a.i.clone())
    kw_b = dict(kw, out=kw["out"].clone(), seg=kw["seg"].clone())
    for call in range(calls):
        slot = 3 + call * steps
        mk.megakernel_step_reference(a, *args, **dict(kw, seg_slot=slot, steps=steps))
        for j in range(steps):
            mk.megakernel_step_reference(b, *args, **dict(kw_b, seg_slot=slot + j))
        assert torch.equal(a.f, b.f) and torch.equal(a.i, b.i), call
        assert mk.lane_state_equal(a, b)
    assert torch.equal(kw["out"], kw_b["out"]) and torch.equal(kw["seg"], kw_b["seg"])
    seg = kw["seg"]
    assert int(a.i[3].min()) == n_gens - 1 and int(a.i[4].sum()) == 0  # drained
    assert int(seg[-steps:].sum()) == 0 and int(seg[3]) > 0
    assert int(seg.sum()) >= cfg.num_cells * cfg.spp
    drained = (a.f.clone(), a.i.clone(), kw["out"].clone())
    mk.megakernel_step_reference(a, *args, **dict(kw, seg_slot=0, steps=steps))
    assert all(torch.equal(x, y) for x, y in zip(drained, (a.f, a.i, kw["out"])))


def test_lane_state_equal_reads_what_a_step_reads():
    """gen and alive of every lane and the path of live lanes count; the
    path rows of an idle lane do not."""
    a = mk.init_lane_state(4, "cpu")
    a.i[4] = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    a.f[:] = torch.arange(48.0).reshape(12, 4)
    b = mk.LaneState(a.f.clone(), a.i.clone())
    b.f[5, 1], b.i[0, 3], b.i[1, 1] = -1.0, 7, 9  # idle lanes' path rows
    assert mk.lane_state_equal(a, b)
    for row, lane in ((None, 0), (0, 2), (2, 0), (3, 1), (4, 3)):
        c = mk.LaneState(b.f.clone(), b.i.clone())
        if row is None:
            c.f[7, lane] += 1.0
        else:
            c.i[row, lane] += 1
        assert not mk.lane_state_equal(a, c), (row, lane)


def test_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    cfg = tp.RenderConfig(width=8, height=6, spp=1, max_depth=6)
    scene = tp.get_scene("box", 8, 6)
    state, args, kw = _step_args(cfg, scene, 64)
    ref_state, _, ref_kw = _step_args(cfg, scene, 64)
    mk.megakernel_step_reference(ref_state, *args, **ref_kw)
    calls = []
    real = mk.megakernel_step_reference
    monkeypatch.setattr(mk, "megakernel_step_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    launches = mk.megakernel_step.launches
    mk.megakernel_step(state, *args, **kw)
    assert calls == [1] and mk.megakernel_step.launches == launches
    assert torch.equal(state.f, ref_state.f) and torch.equal(state.i, ref_state.i)
    assert torch.equal(kw["out"], ref_kw["out"]) and torch.equal(kw["seg"], ref_kw["seg"])
    assert int(kw["seg"][0]) == 64


def test_wrapper_rejects_bad_inputs():
    cfg = tp.RenderConfig(width=8, height=6, spp=1, max_depth=4)
    scene = tp.get_scene("box", 8, 6)
    state, (table, cam, dyn), kw = _step_args(cfg, scene, 64)
    with pytest.raises(ValueError, match="table"):
        mk.megakernel_step(state, table[:, :16], cam, dyn, **kw)
    with pytest.raises(ValueError, match="state"):
        mk.megakernel_step(mk.init_lane_state(32, "cpu"), table, cam, dyn, **kw)
    with pytest.raises(ValueError, match="state"):
        mk.megakernel_step(mk.init_lane_state(64, "cpu", torch.float64), table, cam, dyn, **kw)
    with pytest.raises(ValueError, match="out"):
        mk.megakernel_step(state, table, cam, dyn, **dict(kw, out=torch.zeros((3, 5))))
    with pytest.raises(ValueError, match="seg"):
        mk.megakernel_step(state, table, cam, dyn, **dict(kw, seg_slot=4))
    with pytest.raises(ValueError, match="seg"):
        mk.megakernel_step(state, table, cam, dyn, **dict(kw, seg_slot=2, steps=3))
    for steps in (0, mk.MAX_STEPS + 1, 1.5):
        with pytest.raises(ValueError, match="steps"):
            mk.megakernel_step(state, table, cam, dyn, **dict(kw, steps=steps))
    with pytest.raises(ValueError, match="item range"):
        mk.megakernel_step(state, table, cam, dyn, **dict(kw, lanes=0))
    # The captured batch is for the card only.
    with pytest.raises(ValueError, match="CUDA"):
        mk.megakernel_step_batch(state, table, cam, dyn, batch=2, **{
            k: v for k, v in kw.items() if k != "seg_slot"})
    meta = mk.LaneState(state.f.to("meta"), state.i.to("meta"))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        mk.megakernel_step(meta, table.to("meta"), cam.to("meta"), dyn, **kw)


def test_lane_state_from_arrays_layout():
    """The JAX state dict, [B/128, 128] per field, maps row by row; uint32
    key words keep their bits."""
    rng = np.random.default_rng(3)
    d = {n: rng.random((2, 128), dtype=np.float32) for n in jmk.F32_STATE}
    d.update({n: rng.integers(-1, 50, (2, 128)).astype(np.int32) for n in jmk.I32_STATE})
    d.update({n: rng.integers(0, 2**32, (2, 128), dtype=np.uint64).astype(np.uint32)
              for n in jmk.U32_STATE})
    st = mk.lane_state_from_arrays(d)
    assert st.f.shape == (12, 256) and st.i.shape == (5, 256) and st.i.dtype == torch.int32
    for r, n in enumerate(mk.LANE_F):
        np.testing.assert_array_equal(st.f[r].numpy(), d[n].reshape(-1))
    for r, n in enumerate(mk.LANE_I):
        np.testing.assert_array_equal(st.i[r].numpy().view(d[n].dtype), d[n].reshape(-1))


def test_cli_bench_prints_one_report(capsys):
    assert cli.main(["bench", "--scene", "box", "--width", "8", "--height", "6",
                     "--total-spp", "4", "--max-depth", "8", "--repeats", "1",
                     "--lanes", "64", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert rep["segments"] > 0 and rep["lanes"] == 64 and rep["iters"] > 0
    assert rep["device"] == "cpu" and rep["seconds"] > 0 and 0 < rep["occupancy"] <= 1
    assert rep["camera_rays"] == 8 * 6 * 4


@pytest.mark.parametrize("flag", [["--mesh", "2x1"], ["--scaling"], ["--ring", "8"]])
def test_cli_bench_unported_options_raise(flag, capsys):
    # --suite (tests/test_torch_cli.py::test_bench_suite) and what parallel/
    # serves are ported: --scaling prints a row a mesh size, and bench takes
    # --mesh as the JAX bench does (the per-step render is timed).  Only the
    # result ring is not ported.
    argv = ["bench", "--width", "8", "--height", "6", "--device", "cpu", *flag]
    if flag[0] == "--ring":
        with pytest.raises(SystemExit, match="not ported: the port has no result ring"):
            cli.main(argv)
        return
    assert cli.main(argv) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    if flag[0] == "--scaling":
        assert [r["devices"] for r in lines] == [1] and lines[0]["speedup"] == 1.0
    else:
        assert len(lines) == 1 and lines[0]["camera_rays"] == 8 * 6 * 4
