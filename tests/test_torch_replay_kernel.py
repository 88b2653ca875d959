"""The replay kernel module: the plain version against the TPU kernel, the wrapper.

``replay_persistent_reference`` (the plain PyTorch version of the CUDA
replay kernel: float32 bounce math, float64 accumulation) is held to the
JAX package's Pallas ``replay_param_grads_pallas`` run in interpret mode on
the CPU (float32 accumulation), as ``tests/test_replay_kernel.py`` runs it.
Both take the JAX-packed table and camera of the same perturbed scene, so
the comparison holds the kernel's arithmetic alone.  Tolerance: each field
within 1e-4 of that field's largest magnitude.  (The CUDA kernel is held to
the plain version on the card: tests/test_torch_cuda.py and chip_smoke.py.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.ops.pallas import megakernel as jmk
from cpu_path_tracing_tpu.ops.pallas.replay_kernel import replay_param_grads_pallas
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk
from cpu_path_tracing_tpu_torch.ops.kernels import replay as rk
from cpu_path_tracing_tpu_torch.ops.replay import grads_from_partials

torch.set_num_threads(1)

FIELDS = ("albedo", "emission", "background")
# The static shapes of tests/test_replay_kernel.py's single-generation case
# (rows 8, ring 4, unroll 1), so the interpret-mode compile is shared.
W, H, SPP, DEPTH = 10, 8, 2, 20


def _perturbed(name, cfg, seed=0):
    js = pt.get_scene(name, cfg.width, cfg.height, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        js,
        albedo=jnp.abs(js.albedo + rng.normal(0, 0.03, js.albedo.shape).astype(np.float32))
        + 1e-3,
        emission=jnp.abs(js.emission
                         + rng.normal(0, 0.03, js.emission.shape).astype(np.float32)))


# (cell_start, sample_start): the whole image from sample 0 on the closed
# box, and on the open ``simple`` scene (misses: the background terms) a
# span of the same length from cell 200 at samples 3-4 that runs 120 cells
# past the last one (clamped to it).
@pytest.mark.parametrize("name,cell_start,sample_start", [("box", 0, 0), ("simple", 200, 3)])
def test_plain_version_matches_pallas_kernel(name, cell_start, sample_start):
    jcfg = pt.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    tcfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    js = _perturbed(name, jcfg)
    n_cells = jcfg.num_cells
    ct = np.random.default_rng(1).normal(0, 1, (n_cells, 3)).astype(np.float32)
    ids = jnp.arange(cell_start, cell_start + n_cells, dtype=jnp.int32)
    ref = replay_param_grads_pallas(js, jcfg, ids, sample_start, SPP, jnp.asarray(ct), rows=8,
                                    ring_depth=4, unroll=1, interpret=True)

    table = torch.from_numpy(np.array(jmk.pack_scene(js)))
    cam = torch.from_numpy(np.array(jmk.pack_camera(js)))
    part, stats = rk.replay_persistent_reference(
        table, cam, (cell_start, sample_start), torch.from_numpy(ct), cfg=tcfg,
        n_cells=n_cells, n_items=SPP * n_cells, ior=js.ior)
    assert part.dtype == torch.float64 and part.shape == (7 * table.shape[0] + 6,)
    assert stats["segments"] > SPP * n_cells and 0 < stats["iters"] <= DEPTH
    got = grads_from_partials(torch.from_numpy(np.asarray(js.albedo, np.float64)), part)
    for k in FIELDS:
        a, b = np.asarray(ref[k], np.float64), got[k].numpy()
        assert np.abs(a).max() > 0 or (name == "box" and k == "background"), k
        assert float(np.abs(b - a).max()) <= 1e-4 * float(np.abs(a).max()), k


def test_param_grads_kernel_on_cpu_is_the_plain_version():
    """The gradient entry packs the scene, runs the wrapper (here its plain
    version) and assembles: the wrapper's partials, assembled, and the same
    gradients as the float64 batch replay up to float32 accumulation."""
    from cpu_path_tracing_tpu_torch.ops.replay import replay_param_grads

    cfg = tp.RenderConfig(width=8, height=6, spp=2, max_depth=10)
    scene = tp.get_scene("box", 8, 6)
    ids = torch.arange(cfg.num_cells)
    ct = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (cfg.num_cells, 3))).float()
    got = rk.replay_param_grads_kernel(scene, cfg, ids, 1, 2, ct)
    part, stats = rk.replay_persistent(mk.pack_scene(scene), mk.pack_camera(scene), (0, 1), ct,
                                       cfg=cfg, n_cells=cfg.num_cells, n_items=2 * cfg.num_cells,
                                       ior=scene.ior)
    assert stats["segments"] > 2 * cfg.num_cells
    assembled = grads_from_partials(scene.albedo, part)
    ref = replay_param_grads(scene.double(), cfg, ids, 1, 2, ct.double())
    for k in FIELDS:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], assembled[k].float()), k
        tol = 1e-5 * float(ref[k].abs().max())
        assert float((got[k].double() - ref[k]).abs().max()) <= tol, k


def test_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    cfg = tp.RenderConfig(width=8, height=6, spp=1, max_depth=6)
    scene = tp.get_scene("box", 8, 6)
    ct = torch.ones((cfg.num_cells, 3))
    args = (mk.pack_scene(scene), mk.pack_camera(scene), (0, 0), ct)
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=cfg.num_cells, ior=scene.ior)
    ref, ref_stats = rk.replay_persistent_reference(*args, **kw)
    calls = []
    real = rk.replay_persistent_reference
    monkeypatch.setattr(rk, "replay_persistent_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    launches = rk.replay_persistent.launches
    got, stats = rk.replay_persistent(*args, **kw)
    assert calls == [1] and rk.replay_persistent.launches == launches
    assert torch.equal(got, ref) and stats == ref_stats


@pytest.mark.parametrize("depth", [1, 2, 12])
def test_plain_version_counts_the_nonzero_prefix_terms(depth):
    """``prefix_terms`` is what the bound charges the accumulation: no term
    on a path's first segment (no sphere has been continued from), exactly
    one on every second segment, and from then on at least one and at most
    min(N, segments so far) a segment."""
    cfg = tp.RenderConfig(width=8, height=6, spp=1, max_depth=depth)
    scene = tp.get_scene("box", 8, 6)
    n = cfg.num_cells
    ct = torch.ones((n, 3))
    _, st = rk.replay_persistent_reference(mk.pack_scene(scene), mk.pack_camera(scene), (0, 0), ct,
                                           cfg=cfg, n_cells=n, n_items=n, ior=scene.ior)
    later = st["segments"] - n  # segments after a path's first
    if depth == 1:
        assert st["segments"] == n and st["prefix_terms"] == 0
    elif depth == 2:
        assert later > 0 and st["prefix_terms"] == later
    else:
        assert later < st["prefix_terms"] < scene.num_spheres * later


@pytest.mark.parametrize("case", ["float64", "tent", "spheres"])
def test_wrapper_rejects_what_the_kernel_does_not_do(case):
    """On a device other than the CPU (meta tensors stand in for the card)
    the wrapper launches or raises: a float64 table, tent jitter and more
    than MAX_REPLAY_SPHERES spheres raise ValueError before any launch."""
    name = "random_spheres" if case == "spheres" else "box"
    dtype = torch.float64 if case == "float64" else torch.float32
    scene = tp.get_scene(name, 8, 6)
    cfg = tp.RenderConfig(width=8, height=6, jitter="tent" if case == "tent" else "uniform")
    table, cam = mk.pack_scene(scene, dtype).to("meta"), mk.pack_camera(scene, dtype).to("meta")
    ct = torch.zeros((cfg.num_cells, 3), dtype=dtype, device="meta")
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=cfg.num_cells)
    with pytest.raises(ValueError, match="float32|jitter|spheres"):
        rk.replay_persistent(table, cam, (0, 0), ct, **kw)
    if case == "spheres":
        assert scene.num_spheres > rk.MAX_REPLAY_SPHERES
    ok = tp.get_scene("box", 8, 6)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        rk.replay_persistent(mk.pack_scene(ok).to("meta"), mk.pack_camera(ok).to("meta"), (0, 0),
                             torch.zeros((cfg.num_cells, 3), device="meta"),
                             **dict(kw, cfg=cfg.replace(jitter="uniform")))
