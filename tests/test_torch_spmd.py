"""The mesh's SPMD runner (``cpu_path_tracing_tpu_torch/parallel/spmd.py``)
on meshes of repeated CPU devices, where it makes the same calls as on the
card, without streams (its streams are held on the card in
``tests/test_torch_cuda.py``).

* The sharded render through the runner equals, bit for bit, a serial loop
  written here over the same per-shard function on 1x1, 4x1, 2x2 and 2x4
  meshes, and a tiles-only mesh equals the one pass; the 2x4 render agrees
  with the JAX ``render_image_sharded`` on a 2x4 mesh of conftest's virtual
  devices in float64 within 1e-12 (scale-aware).
* The shards are called in mesh order and come back as ``out[t][s]``.
* A shard's exception reaches the caller, naming the entry; no later shard
  is called and no result is returned.
* The NaN guard (a context variable) fires inside a shard.
* The accumulating step on a mesh over two devices (``'cpu'`` and
  ``'cpu:0'``) runs a worker process a device (``parallel/cards.py``) and
  gives the in-process step's loss and gradients bitwise; a worker's
  failure, and a worker's death, reach the caller.
"""

import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cpu_path_tracing_tpu.parallel.render import render_image_sharded as jax_render_image_sharded
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import grad
from cpu_path_tracing_tpu_torch.parallel import spmd
from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh
from cpu_path_tracing_tpu_torch.parallel.render import (
    render_cells_sharded,
    render_image_sharded,
    sum_shards,
    tile_span,
)
from cpu_path_tracing_tpu_torch.render import render_cells, render_cells_range
from cpu_path_tracing_tpu_torch.utils.debug import debug_context
from cpu_path_tracing_tpu_torch.utils.parity import scale_aware

torch.set_num_threads(1)

CFG = tp.RenderConfig(width=20, height=12, spp=4, max_depth=16)


def cpus(n):
    return ["cpu"] * n


def serial_cells(scene, cfg, n_tiles, n_samples):
    """The sharded render's cells by a serial loop over the mesh's entries,
    each the runner's per-shard call, the shards added in shard order."""
    per = tile_span(cfg, n_tiles)
    spp_local = cfg.spp // n_samples
    outs = []
    for t in range(n_tiles):
        start = t * per
        if start >= cfg.num_cells:
            break
        ids = torch.arange(start, start + per, dtype=torch.int64)
        parts = [render_cells_range(scene, cfg, ids, s * spp_local, spp_local)
                 for s in range(n_samples)]
        outs.append((sum_shards(parts, "cpu") / cfg.spp)[:cfg.num_cells - start])
    return torch.cat(outs, dim=0)


@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (2, 2), (2, 4)],
                         ids=["1x1", "4x1", "2x2", "2x4"])
def test_sharded_render_equals_the_serial_order(shape):
    scene = tp.get_scene("box_mirror", CFG.width, CFG.height)
    n = shape[0] * shape[1]
    got = render_cells_sharded(scene, CFG, make_mesh(*shape, cpus(n)))
    assert torch.equal(got, serial_cells(scene, CFG, *shape))
    if shape[1] == 1:
        assert torch.equal(got, render_cells(scene, CFG, torch.arange(CFG.num_cells)))


def test_2x4_matches_jax_sharded_render_float64():
    kw = dict(width=16, height=12, spp=4, max_depth=16)
    jcfg = pt.RenderConfig(**kw)
    ref = np.asarray(jax_render_image_sharded(
        pt.get_scene("box", jcfg.width, jcfg.height, dtype=jnp.float64), jcfg,
        jax_make_mesh(n_tiles=2, n_samples=4)))
    cfg = tp.RenderConfig(**kw)
    got = render_image_sharded(tp.get_scene("box", cfg.width, cfg.height, dtype=torch.float64),
                               cfg, make_mesh(2, 4, cpus(8))).numpy()
    assert got.dtype == ref.dtype == np.float64
    assert float(scale_aware(got, ref).max()) < 1e-12


def test_shards_are_called_in_mesh_order():
    calls = []

    def shard(t, s, d):
        calls.append((t, s))
        return (t, s, str(d))

    out = spmd.run(make_mesh(2, 3, cpus(6)), shard)
    assert calls == [(t, s) for t in range(2) for s in range(3)]
    assert out == [[(t, s, "cpu") for s in range(3)] for t in range(2)]


def test_a_shards_exception_reaches_the_caller():
    calls = []

    def shard(t, s, d):
        calls.append(t)
        if t == 1:
            raise ValueError(f"shard {t} failed")
        return t

    with pytest.raises(ValueError, match="shard 1 failed") as info:
        spmd.run(make_mesh(4, 1, cpus(4)), shard)
    assert calls == [0, 1]
    assert "in mesh entry (1, 0) on cpu" in info.value.__notes__


def test_nan_guard_fires_inside_a_shard():
    scene = tp.get_scene("box", CFG.width, CFG.height)
    scene.emission[7] = float("nan")  # the light
    mesh = make_mesh(2, 1, cpus(2))
    assert torch.isnan(render_cells_sharded(scene, CFG, mesh)).any()  # unguarded: no check
    with pytest.raises(FloatingPointError, match="render_cells_range") as info:
        with debug_context(nans=True):
            render_cells_sharded(scene, CFG, mesh)
    assert "in mesh entry (0, 0) on cpu" in info.value.__notes__


# ---- the accumulating step on a mesh over several devices: a worker process a device ----

ACC_CFG = tp.RenderConfig(width=10, height=8, spp=4, max_depth=8)
# 'cpu' and 'cpu:0' are two devices to the mesh, as two cards are: a worker process each.
TWO_DEVICES = ["cpu", "cpu", "cpu:0", "cpu:0"]


def _mesh_workers():
    return [p for p in multiprocessing.active_children() if p.name.startswith("mesh-")]


@pytest.fixture(scope="module")
def accum_case():
    scene = tp.get_scene("box", ACC_CFG.width, ACC_CFG.height, dtype=torch.float64)
    target = grad.render_target(scene, ACC_CFG) * 0.9
    return scene, target, grad.split_params(scene, ("albedo", "emission"))


def test_accum_step_over_two_devices_equals_the_in_process_step(accum_case):
    """Each device's shards in a worker process of its own give the loss
    and gradients of the same mesh shape run in this process, bitwise, and
    again on a second call; closing stops the workers."""
    scene, target, params = accum_case
    ref = grad.make_sharded_accum_loss_grad(make_mesh(2, 2, cpus(4)), scene, ACC_CFG,
                                            cell_chunk=64)(params, target)
    lg = grad.make_sharded_accum_loss_grad(make_mesh(2, 2, TWO_DEVICES), scene, ACC_CFG,
                                           cell_chunk=64)
    try:
        assert sorted(p.name for p in _mesh_workers()) == ["mesh-cpu", "mesh-cpu:0"]
        for _ in range(2):
            loss, grads = lg(params, target)
            assert torch.equal(loss, ref[0])
            assert all(torch.equal(grads[k], ref[1][k]) for k in ref[1])
    finally:
        lg.close()
    assert not _mesh_workers()


def test_a_workers_failure_reaches_the_caller(accum_case):
    """The NaN guard fires in a worker and raises in the caller, naming the
    worker; a worker that dies fails the next call."""
    scene, target, params = accum_case
    bad = {k: v.clone() for k, v in params.items()}
    bad["emission"][7] = float("nan")
    lg = grad.make_sharded_accum_loss_grad(make_mesh(2, 2, TWO_DEVICES), scene, ACC_CFG)
    try:
        with pytest.raises(FloatingPointError, match="render_cells_range") as info:
            with debug_context(nans=True):
                lg(bad, target)
        assert any("in the mesh worker of cpu" in note for note in info.value.__notes__)
        victim = _mesh_workers()[0]
        victim.kill()
        victim.join(timeout=30)
        assert not victim.is_alive()
        with pytest.raises(RuntimeError, match="mesh worker of .* died"):
            lg(params, target)
    finally:
        lg.close()
    assert not _mesh_workers()
