"""The port's fault-tolerant tile orchestrator
(``cpu_path_tracing_tpu_torch/orchestrator.py``), case for case with
``tests/test_faults.py``, and against the JAX package.

* Tiled equals untiled ``render_image`` bitwise for every tile size the JAX
  test takes, retried tiles included, in float32 and float64.
* ``tile_spans`` and ``FaultInjector.parse`` give the JAX results.
* Against the JAX ``render_tiled`` on the same (scene, config, seed):
  float32 at most 0.1% of pixels above 1e-5 scale-aware; float64 against
  the JAX untiled float64 render within 1e-12 (the JAX orchestrator keeps
  float32 sums, the port the scene's dtype).
* A resumed run renders only the missing tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu import orchestrator as jax_orch
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch.orchestrator import (
    FaultInjector,
    InjectedFault,
    TileRenderError,
    TileState,
    render_tiled,
    tile_spans,
)
from cpu_path_tracing_tpu_torch.render import render_cells_range, render_image
from cpu_path_tracing_tpu_torch.utils.parity import scale_aware

torch.set_num_threads(1)

CFG = tp.RenderConfig(width=16, height=12, spp=2, max_depth=8)
JCFG = pt.RenderConfig(width=16, height=12, spp=2, max_depth=8, integrator="wavefront")


@pytest.fixture(scope="module")
def scene():
    return tp.get_scene("box", CFG.width, CFG.height)


@pytest.fixture(scope="module")
def untiled(scene):
    return render_image(scene, CFG)


@pytest.mark.parametrize("tile_cells", [1, 64, 100, 200, 10**9])
def test_tile_spans_pixel_aligned(tile_cells):
    spans, tc = tile_spans(CFG, tile_cells)
    ns2 = CFG.num_subpixels**2
    assert tc % ns2 == 0
    assert spans[0][0] == 0 and spans[-1][1] == CFG.num_cells
    for (s0, e0), (s1, _) in zip(spans, spans[1:]):
        assert e0 == s1  # contiguous, no overlap
    assert (spans, tc) == jax_orch.tile_spans(JCFG, tile_cells)


@pytest.mark.parametrize("tile_cells", [64, 200, 10**9])
def test_tiled_matches_untiled_bitwise(scene, untiled, tile_cells):
    assert torch.equal(render_tiled(scene, CFG, tile_cells=tile_cells), untiled)


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32), (jnp.float64, torch.float64)],
                         ids=["f32", "f64"])
def test_tiled_matches_jax(dtypes):
    jd, td = dtypes
    ts = tp.get_scene("box_mirror", 16, 12, dtype=td)
    got = render_tiled(ts, CFG, tile_cells=64)
    assert got.dtype == td and torch.equal(got, render_image(ts, CFG))
    js = pt.get_scene("box_mirror", 16, 12, dtype=jd)
    if td == torch.float32:
        ref = np.asarray(jax_orch.render_tiled(js, JCFG, tile_cells=64))
        assert float(np.mean(scale_aware(got.numpy(), ref) > 1e-5)) <= 1e-3
    else:
        ref = np.asarray(pt.render_image(js, JCFG))
        assert float(scale_aware(got.numpy(), ref).max()) < 1e-12


def test_injected_fault_retried_and_bit_identical(scene, untiled):
    inj = FaultInjector({1: 2, 3: 1})
    img = render_tiled(scene, CFG, tile_cells=64, max_retries=2, fault_injector=inj)
    assert torch.equal(img, untiled)
    assert inj.attempts[1] == 3  # 2 failures + 1 success
    assert inj.attempts[3] == 2


def test_gives_up_past_max_retries(scene):
    inj = FaultInjector({0: 99})
    with pytest.raises(TileRenderError) as info:
        render_tiled(scene, CFG, tile_cells=64, max_retries=1, fault_injector=inj)
    assert isinstance(info.value.__cause__, InjectedFault)  # the last error, chained
    assert inj.attempts[0] == 2


def test_parse_spec():
    inj = FaultInjector.parse("3:2,7")
    assert inj.fail_tiles == {3: 2, 7: 1}
    for spec in ("3:2,7", "0", "1:2,4", "5:1,,6:3"):
        assert FaultInjector.parse(spec).fail_tiles == jax_orch.FaultInjector.parse(spec).fail_tiles


def test_resume_renders_only_missing_tiles(scene, untiled, tmp_path):
    ckpt = str(tmp_path / "tiles.npz")

    # First run dies (injected, zero retries) after finishing some tiles.
    with pytest.raises(TileRenderError):
        render_tiled(scene, CFG, tile_cells=64, checkpoint_path=ckpt, max_retries=0,
                     fault_injector=FaultInjector({3: 1}))
    assert TileState.load(ckpt).done.tolist() == [True] * 3 + [False] * 9

    # Second run resumes; an instrumented render_fn counts tiles re-rendered.
    calls = []

    def counting_render(sc, ids, start, n):
        calls.append(int(ids[0]))
        return render_cells_range(sc, CFG, ids, start, n)

    img = render_tiled(scene, CFG, tile_cells=64, checkpoint_path=ckpt,
                       render_fn=counting_render)
    assert torch.equal(img, untiled)
    spans, _ = tile_spans(CFG, 64)
    assert calls == [s for s, _ in spans[3:]]  # tiles 0..2 came from the checkpoint


def test_checkpoint_fingerprint_mismatch(scene, tmp_path):
    ckpt = str(tmp_path / "tiles.npz")
    render_tiled(scene, CFG, tile_cells=64, checkpoint_path=ckpt)
    other = tp.get_scene("simple", CFG.width, CFG.height)
    with pytest.raises(ValueError, match="different"):
        render_tiled(other, CFG, tile_cells=64, checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="different"):  # another tiling
        render_tiled(scene, CFG, tile_cells=128, checkpoint_path=ckpt)


def test_injector_is_deterministic():
    inj = FaultInjector({0: 1})
    with pytest.raises(InjectedFault):
        inj(0)
    inj(0)  # second attempt passes
    inj(1)  # un-listed tiles never fail
