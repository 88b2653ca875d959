"""The kernel module: the plain version against the TPU kernel, the wrapper.

``persistent_render_reference`` (the plain PyTorch version of the CUDA
kernel) is held to the JAX package's Pallas ``persistent_render`` run in
interpret mode on the CPU, as ``tests/test_wavefront.py`` runs it.  Both
are fed the JAX-packed table and camera, so the test holds the kernel math
alone.  Float32 sqrt/rsqrt/sin/cos differ by an ulp between XLA and PyTorch
on the CPU, so per-item radiance agrees within 1e-5 scale-aware on >= 99.9%
of items, and the segment counts within 0.1%.  (The CUDA kernel itself is
held to the plain version on the card: tests/test_torch_cuda.py and
chip_smoke.py.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.ops.pallas import megakernel as jmk
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import _build
from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk
from cpu_path_tracing_tpu_torch.utils.parity import scale_aware

torch.set_num_threads(1)

W, H, SPP, DEPTH, ROWS, RING = 16, 12, 2, 8, 8, 4


# (cell_start, sample_start), cells in the span: the whole image; and a span
# from cell 300 that runs past the last cell (clamped to it) at samples 3-4.
# Both launch more items than the Pallas kernel's 1024 lanes, so lanes
# regenerate.
@pytest.mark.parametrize("dyn,n_cells", [((0, 0), W * H * 4), ((300, 3), 600)])
def test_plain_version_matches_pallas_kernel(dyn, n_cells):
    jcfg = pt.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    tcfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    scene = pt.get_scene("box_mirror", W, H, dtype=jnp.float32)
    table = np.array(jmk.pack_scene(scene))  # writable copies for torch.from_numpy
    cam = np.array(jmk.pack_camera(scene))
    n_items = n_cells * SPP
    lanes = ROWS * jmk.LANE
    n_gens = -(-n_items // lanes)
    assert n_items > lanes
    out, nseg, _ = jmk.persistent_render(
        jnp.asarray(table), jnp.asarray(cam), jnp.asarray(dyn, jnp.int32), cfg=jcfg,
        n_spheres=table.shape[0], n_cells=n_cells, n_items=n_items, n_gens=n_gens,
        rows=ROWS, ring_depth=RING, interpret=True, ior=scene.ior, unroll=1)
    # out[g, c, row, lane]: flat (g*lanes + row*128 + lane) is the item.
    ref = np.asarray(out).transpose(1, 0, 2, 3).reshape(3, n_gens * lanes)[:, :n_items]

    got, stats = mk.persistent_render_reference(
        torch.from_numpy(table), torch.from_numpy(cam), dyn, cfg=tcfg,
        n_cells=n_cells, n_items=n_items, ior=scene.ior)
    assert got.shape == (3, n_items) and got.dtype == torch.float32
    dev = scale_aware(got.numpy(), ref).max(axis=0)
    assert float(np.mean(dev < 1e-5)) >= 0.999, float(np.mean(dev < 1e-5))
    assert abs(stats["segments"] - int(nseg)) <= 1e-3 * int(nseg)
    assert stats["lanes"] == n_items and 0 < stats["iters"] <= DEPTH


def test_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    cfg = tp.RenderConfig(width=8, height=6, spp=1, max_depth=6)
    scene = tp.get_scene("box", 8, 6)
    args = (mk.pack_scene(scene), mk.pack_camera(scene), (0, 0))
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=cfg.num_cells, ior=scene.ior)
    ref, ref_stats = mk.persistent_render_reference(*args, **kw)
    calls = []
    real = mk.persistent_render_reference
    monkeypatch.setattr(mk, "persistent_render_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    launches = mk.persistent_render.launches
    got, stats = mk.persistent_render(*args, **kw)
    assert calls == [1] and mk.persistent_render.launches == launches
    assert torch.equal(got, ref) and stats == ref_stats


def test_wrapper_rejects_bad_inputs():
    cfg = tp.RenderConfig(width=8, height=6, spp=1, max_depth=4)
    scene = tp.get_scene("box", 8, 6)
    table, cam = mk.pack_scene(scene), mk.pack_camera(scene)
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=cfg.num_cells)
    with pytest.raises(ValueError, match="table"):
        mk.persistent_render(table[:, :16], cam, (0, 0), **kw)
    with pytest.raises(ValueError, match="dtype"):
        mk.persistent_render(table, cam.double(), (0, 0), **kw)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        mk.persistent_render(table.to("meta"), cam.to("meta"), (0, 0), **kw)


def test_plain_version_float64_and_chunking(monkeypatch):
    """The plain version renders in the table's dtype, and its item chunking
    does not change a result."""
    cfg = tp.RenderConfig(width=8, height=6, spp=2, max_depth=12)
    scene = tp.get_scene("simple", 8, 6, dtype=torch.float64)
    args = (mk.pack_scene(scene, torch.float64), mk.pack_camera(scene, torch.float64), (0, 1))
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=2 * cfg.num_cells, ior=scene.ior)
    whole, st = mk.persistent_render_reference(*args, **kw)
    monkeypatch.setattr(mk, "REFERENCE_CHUNK", 50)
    parts, st_parts = mk.persistent_render_reference(*args, **kw)
    assert whole.dtype == torch.float64
    assert torch.equal(whole, parts) and st["segments"] == st_parts["segments"]


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found.*sm_90a"):
        _build.build()
    assert list(tmp_path.iterdir()) == []


# ---- the launch rules of the redesigned kernels (no card needed) ----

def _params(n_items, n_cells, cell_start=0, sample_start=0, width=1024, height=768):
    cfg = tp.RenderConfig(width=width, height=height, spp=1)
    return mk.launch_params(cfg, (cell_start, sample_start), n_spheres=8, n_cells=n_cells,
                            n_items=n_items, ior=2.0)


@pytest.mark.parametrize("kw, bits", [
    (dict(n_items=25_165_824, n_cells=3_145_728), 32),        # the main path
    (dict(n_items=2_097_152, n_cells=131_072), 32),           # a train chunk
    (dict(n_items=2**31 - 1, n_cells=2**31 - 1), 32),
    (dict(n_items=2**31, n_cells=2**20), 64),                 # items
    (dict(n_items=2**20, n_cells=2**20, cell_start=2**31 - 2**20), 64),  # the span's last cell
    (dict(n_items=2**20, n_cells=2**20, cell_start=2**31 - 2**20 - 1), 32),
    (dict(n_items=64, n_cells=16, sample_start=2**31 - 4), 64),          # the last sample
    (dict(n_items=64, n_cells=16, sample_start=2**31 - 5), 32),
    (dict(n_items=64, n_cells=16, width=32768, height=32768), 64),       # the image's cells
])
def test_index_bits_follow_the_span(kw, bits):
    """The kernels index in 32 bits exactly when every index they form for
    the launch is below 2^31."""
    assert mk.index_bits(_params(**kw)) == bits


@pytest.mark.parametrize("n_items, warps", [(1, 8), (21, 8), (31, 1), (32, 4), (33, 4),
                                            (24_690, 776), (300_002, 4224), (4224 * 32 * 3, 4224),
                                            (1_000_003, 1584)])
def test_warp_owned_items_cover_every_item_once(n_items, warps):
    """A NumPy model of the replay kernel's item map (csrc/replay.cu:
    owned_positions, item_at), not a call into it: warp w of W walks chunks
    w, w + W, ... of 32 consecutive items.  In the model every item below
    n_items belongs to exactly one position of one warp, and a warp meets
    its items in ascending order.  That the CUDA source follows the model is
    checked on the card, where a wrong map loses or repeats segments
    (tests/test_torch_cuda.py: the replay kernel's segment count against its
    plain version's on ragged spans)."""
    log2 = 5
    chunks = (n_items + (1 << log2) - 1) >> log2
    seen = np.zeros(n_items, np.int64)
    for w in range(warps):
        owned = ((chunks - w + warps - 1) // warps if w < chunks else 0) << log2
        pos = np.arange(owned, dtype=np.int64)
        item = (((pos >> log2) * warps + w) << log2) | (pos & ((1 << log2) - 1))
        assert np.all(np.diff(item) > 0)
        item = item[item < n_items]
        seen[item] += 1
    assert np.all(seen == 1)
