"""The port's forward render end to end, against the JAX package.

* Float64: the port's ``render_image`` against the JAX ``render_image``
  (XLA wavefront integrator) on the same (scene, config, seed): both draw
  bit-identical uniforms and run the same expressions, so images agree to
  float64 rounding (max scale-aware deviation < 1e-9).
* Float32: against the committed pins ``tests/data/pin_*_64x48.npz`` (JAX
  batch integrator, CPU float32, ``tests/test_goldens.py`` config): a pixel
  may move when a float32 ulp flips a discrete decision, so by
  ``utils/parity.pin_gate`` at most 1% of pixels may deviate (worst
  channel) by more than 1e-4 and channel means agree within 0.5%.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.render import camera_rays_for_cells as jax_camera_rays
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import cli, render
from cpu_path_tracing_tpu_torch.utils.parity import pin_gate, scale_aware

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


@pytest.mark.parametrize("name", ["box", "box_mirror", "simple"])
def test_render_image_f64_matches_jax(name):
    jcfg = pt.RenderConfig(width=32, height=24, spp=2, max_depth=16, integrator="wavefront")
    tcfg = tp.RenderConfig(width=32, height=24, spp=2, max_depth=16)
    ref = np.asarray(pt.render_image(pt.get_scene(name, 32, 24, dtype=jnp.float64), jcfg))
    got = tp.render_image(tp.get_scene(name, 32, 24, dtype=torch.float64), tcfg)
    assert got.dtype == torch.float64 and got.shape == (24, 32, 3)
    assert float(scale_aware(got.numpy(), ref).max()) < 1e-9


@pytest.mark.parametrize("name", ["box", "box_mirror", "simple"])
def test_render_image_f32_matches_pins(name):
    cfg = tp.RenderConfig(width=64, height=48, spp=2, max_depth=16)
    img = tp.render_image(tp.get_scene(name, 64, 48), cfg).numpy()
    ref = np.load(os.path.join(DATA, f"pin_{name}_64x48.npz"))["img"]
    rec = pin_gate(img, ref, mean_tol=0.005)
    assert rec["ok"], rec


@pytest.mark.parametrize("jitter", ["uniform", "tent"])
def test_camera_rays_match_jax(jitter):
    jcfg = pt.RenderConfig(width=24, height=16, jitter=jitter)
    tcfg = tp.RenderConfig(width=24, height=16, jitter=jitter)
    u4 = np.random.default_rng(5).random((jcfg.num_cells, 4))
    ids = np.arange(jcfg.num_cells)
    jo, jd = jax_camera_rays(pt.get_scene("depth_of_field", 24, 16, dtype=jnp.float64), jcfg,
                             jnp.asarray(ids), jnp.asarray(u4), jnp.float64)
    to, td = render.camera_rays_for_cells(tp.get_scene("depth_of_field", 24, 16, torch.float64),
                                          tcfg, torch.from_numpy(ids), torch.from_numpy(u4),
                                          torch.float64)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-13)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-13)


def test_sample_ranges_and_cell_chunks_add_up():
    cfg = tp.RenderConfig(width=8, height=6, spp=4, max_depth=12)
    scene = tp.get_scene("box", 8, 6, dtype=torch.float64)
    ids = torch.arange(cfg.num_cells)
    full = render.render_cells_range(scene, cfg, ids, 0, 4)
    halves = (render.render_cells_range(scene, cfg, ids, 0, 2)
              + render.render_cells_range(scene, cfg, ids, 2, 2))
    torch.testing.assert_close(halves, full, rtol=1e-12, atol=1e-12)
    whole = tp.render_image(scene, cfg)
    chunked = tp.render_image(scene, cfg.replace(ray_chunk=20))
    assert torch.equal(whole, chunked)
    with pytest.raises(ValueError, match="contiguous"):
        render.render_cells_range(scene, cfg, torch.tensor([0, 2, 4]), 0, 1)


def test_cli_render_writes_png(tmp_path):
    out = tmp_path / "box.png"
    assert cli.main(["render", "--scene", "box", "--width", "16", "--height", "12",
                     "--total-spp", "4", "--max-depth", "6", "--device", "cpu",
                     "-o", str(out)]) == 0
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IHDR" in data[:16]


def test_import_leaves_jax_out():
    code = ("import sys, cpu_path_tracing_tpu_torch as tp; "
            "tp.render_image(tp.get_scene('simple', 4, 3), tp.RenderConfig(width=4, height=3, "
            "max_depth=2)); bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'cpu_path_tracing_tpu.'))] + (['cpu_path_tracing_tpu'] if "
            "'cpu_path_tracing_tpu' in sys.modules else []); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("change", [dict(dtype=torch.float64), dict(jitter="tent")])
def test_cuda_scene_without_kernel_support_raises(monkeypatch, change):
    """A CUDA scene in float64 or with tent jitter raises when the kernels
    are asked for (integrator='pallas') instead of falling back; 'auto'
    sends it to the plain wavefront loop before anything launches.  (No
    card here: the device check is patched.)"""
    monkeypatch.setattr(render, "_on_cuda", lambda scene: True)
    scene = tp.get_scene("box", 8, 6, dtype=change.get("dtype", torch.float32))
    cfg = tp.RenderConfig(width=8, height=6, jitter=change.get("jitter", "uniform"),
                          integrator="pallas")
    with pytest.raises(ValueError, match="integrator='wavefront' renders it"):
        render.resolve_integrator(scene, cfg)
    with pytest.raises(ValueError, match="integrator='wavefront' renders it"):
        tp.render_image(scene, cfg)
    assert render.resolve_integrator(scene, cfg.replace(integrator="auto")) == "wavefront"
    monkeypatch.setattr(render, "_on_cuda", lambda scene: False)
    assert render.resolve_integrator(scene, cfg.replace(integrator="auto")) == "plain"


def test_float32_cuda_scene_resolves_to_the_kernel(monkeypatch):
    monkeypatch.setattr(render, "_on_cuda", lambda scene: True)
    cfg = tp.RenderConfig(width=8, height=6)
    assert render.resolve_integrator(tp.get_scene("box", 8, 6), cfg) == "pallas"
