"""The port's command line and scene loader against the JAX package's.

* A scene saved by the JAX ``scene_to_dict`` (with its ``anchor_dir``
  fields) loads in the port to the sphere arrays the JAX loader gives,
  ``p0`` exactly: both do the anchor math in float64 NumPy and cast once.
* ``cli invert`` starts from the JAX CLI's perturbed parameters whatever the
  order of ``--fields``: one NumPy stream, drawn in sorted key order.  The
  noise is float64 NumPy cast to the parameter's dtype in both, and added in
  float32 by each framework: exact (tolerance 0).
* ``cli render`` writes ``image.png`` by default, as the JAX CLI does.
* ``--subpixels`` and ``--rr-depth`` reach ``RenderConfig``, and
  ``--total-spp`` divides by the chosen ``subpixels**2``; a float64 render
  at ``--subpixels 1 --rr-depth 2`` agrees with the JAX package's to
  float64 rounding (scale-aware deviation < 1e-9).
* The host runtime's flags, as ``tests/test_cli.py`` drives the JAX ones:
  ``--checkpoint``/``--flush-every`` (progressive), ``--tile-cells`` with
  ``--inject-fault`` and ``--max-retries`` (a tiled image is the one-pass
  image byte for byte, and a failed run resumes to it), ``invert
  --checkpoint`` (a resumed run ends where the uninterrupted one does,
  bitwise), ``--debug-nans``, and ``bench --suite`` on a shrunk matrix.
  The flags of ``parallel/`` parse as the JAX CLI's do (they run in
  tests/test_torch_parallel.py and tests/test_torch_distributed.py); only
  ``bench --ring`` is left unported.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu import cli as jax_cli
from cpu_path_tracing_tpu.grad import split_params as jax_split_params
from cpu_path_tracing_tpu.models.io import scene_from_dict as jax_scene_from_dict
from cpu_path_tracing_tpu.models.io import scene_to_dict as jax_scene_to_dict
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import cli, grad
from cpu_path_tracing_tpu_torch.models.io import scene_from_dict
from cpu_path_tracing_tpu_torch.utils.parity import scale_aware

torch.set_num_threads(1)

SPHERE_FIELDS = ("p0", "radius", "anchor_dir", "emission", "albedo", "material", "background")


def _off_axis_scene(dtype):
    """A JAX scene whose anchors do not face the look-at point, so that
    re-deriving them on load would move ``p0``."""
    cam = pt.get_scene("box", 40, 30, dtype=dtype).camera
    spheres = [(1e5, (1e5 + 1.0, 40.8, 81.6), (0, 0, 0), (0.75, 0.25, 0.25), pt.DIFFUSE),
               (16.5, (27.0, 16.5, 47.0), (0, 0, 0), (0.999, 0.999, 0.999), pt.SPECULAR),
               (600.0, (50.0, 681.33, 81.6), (12, 12, 12), (0.0, 0.0, 0.0), pt.DIFFUSE)]
    dirs = np.array([[-1.0, 0.0, 0.0], [0.6, 0.0, 0.8], [0.0, -1.0, 0.0]])
    return pt.scene_from_spheres(spheres, cam, dtype=dtype, anchor_dirs=dirs)


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32), (jnp.float64, torch.float64)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["box", "smallpt", "off_axis"])
def test_scene_saved_by_jax_loads_with_its_anchors(name, dtypes):
    jd, td = dtypes
    saved = _off_axis_scene(jd) if name == "off_axis" else pt.get_scene(name, 40, 30, dtype=jd)
    d = jax_scene_to_dict(saved)
    assert all("anchor_dir" in s for s in d["spheres"])
    ref, got = jax_scene_from_dict(d, 40, 30, dtype=jd), scene_from_dict(d, 40, 30, dtype=td)
    assert got.ior == ref.ior
    for f in SPHERE_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    # Without the saved anchors the loader derives them from the look-at point.
    for s in d["spheres"]:
        del s["anchor_dir"]
    ref, got = jax_scene_from_dict(d, 40, 30, dtype=jd), scene_from_dict(d, 40, 30, dtype=td)
    np.testing.assert_array_equal(got.p0.numpy(), np.asarray(ref.p0))
    np.testing.assert_array_equal(got.anchor_dir.numpy(), np.asarray(ref.anchor_dir))


def test_scene_from_spheres_takes_anchor_dirs():
    cam = tp.get_scene("box", 8, 6).camera
    dirs = [[0.0, 1.0, 0.0], [0.0, 0.0, -1.0]]
    spheres = [(2.0, (0.0, 0.0, 0.0), (0, 0, 0), (0.5, 0.5, 0.5), tp.DIFFUSE),
               (1e6, (0.0, 0.0, 1e6), (0, 0, 0), (0.5, 0.5, 0.5), tp.DIFFUSE)]
    scene = tp.scene_from_spheres(spheres, cam, anchor_dirs=dirs, dtype=torch.float64)
    np.testing.assert_array_equal(scene.anchor_dir.numpy(), np.asarray(dirs))
    np.testing.assert_array_equal(scene.p0.numpy(), [[0.0, 2.0, 0.0], [0.0, 0.0, 0.0]])


@pytest.mark.parametrize("fields", ["emission,albedo", "albedo,emission",
                                    "background,albedo,emission"])
def test_invert_start_does_not_depend_on_field_order(fields):
    seed, perturb = 7, 0.05
    names = tuple(fields.split(","))
    got = cli.perturbed_params(grad.split_params(tp.get_scene("box", 8, 6), names), seed, perturb)
    assert tuple(got) == names  # the dict keeps the caller's order; the draws do not
    # The JAX CLI's start (cmd_invert): tree.map visits keys in sorted order.
    rng = np.random.default_rng(seed)
    ref = jax.tree.map(lambda x: x + jnp.asarray(rng.normal(0, perturb, x.shape), x.dtype),
                       jax_split_params(pt.get_scene("box", 8, 6, dtype=jnp.float32), names))
    for k in names:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    again = cli.perturbed_params(
        grad.split_params(tp.get_scene("box", 8, 6), tuple(sorted(names))), seed, perturb)
    for k in names:
        assert torch.equal(got[k], again[k]), k


def test_render_writes_image_png_by_default():
    args = cli._parser().parse_args(["render"])
    assert args.out == "image.png"
    jax_parser_source = open(jax_cli.__file__).read()
    assert '"-o", "--out", default="image.png"' in jax_parser_source


@pytest.mark.parametrize("argv,expect", [
    ([], dict(num_subpixels=2, rr_depth=4, spp=1)),
    (["--subpixels", "1", "--rr-depth", "2"], dict(num_subpixels=1, rr_depth=2, spp=4)),
    (["--subpixels", "3", "--total-spp", "27"], dict(num_subpixels=3, spp=3)),
    (["--subpixels", "3", "--total-spp", "4"], dict(num_subpixels=3, spp=1)),
    (["--subpixels", "1", "--spp", "5", "--rr-depth", "0"],
     dict(num_subpixels=1, spp=5, rr_depth=0)),
])
def test_config_takes_subpixels_and_rr_depth(argv, expect):
    for cmd in ("render", "invert", "bench"):
        cfg = cli._config(cli._parser().parse_args([cmd, *argv]))
        for k, v in expect.items():
            assert getattr(cfg, k) == v, (cmd, k)
        assert cfg.total_spp == cfg.spp * cfg.num_subpixels ** 2
        assert cfg.num_cells == cfg.width * cfg.height * cfg.num_subpixels ** 2


def test_render_at_one_subpixel_and_early_roulette_matches_jax(tmp_path):
    argv = ["render", "--scene", "box", "--width", "16", "--height", "12", "--subpixels", "1",
            "--rr-depth", "2", "--total-spp", "3", "--max-depth", "12", "--seed", "3"]
    cfg = cli._config(cli._parser().parse_args(argv))
    assert (cfg.num_subpixels, cfg.rr_depth, cfg.spp, cfg.num_cells) == (1, 2, 3, 16 * 12)
    jcfg = pt.RenderConfig(width=16, height=12, spp=3, num_subpixels=1, rr_depth=2,
                           max_depth=12, seed=3, integrator="wavefront")
    ref = np.asarray(pt.render_image(pt.get_scene("box", 16, 12, dtype=jnp.float64), jcfg))
    got = tp.render_image(tp.get_scene("box", 16, 12, dtype=torch.float64), cfg).numpy()
    dev = scale_aware(got, ref)
    assert got.shape == (12, 16, 3) and float(dev.max()) < 1e-9
    # A roulette depth that matters: the default's image differs.
    other = tp.render_image(tp.get_scene("box", 16, 12, dtype=torch.float64),
                            cfg.replace(rr_depth=4)).numpy()
    assert np.abs(other - got).max() > 1e-6
    out = tmp_path / "one.png"
    assert cli.main([*argv, "--device", "cpu", "-o", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


SMALL = ["--width", "24", "--height", "16", "--spp", "1", "--max-depth", "8", "--device", "cpu"]


def test_render_checkpointed(tmp_path):
    out = str(tmp_path / "img.png")
    ck = str(tmp_path / "ck.npz")
    rc = cli.main(["render", "--scene", "box", *SMALL, "-o", out, "--checkpoint", ck,
                   "--flush-every", "1"])
    assert rc == 0
    z = np.load(ck)
    assert int(z["spp_done"]) == 1


def test_render_tiled_with_faults_and_resume(tmp_path):
    """--tile-cells with injected faults writes the one-pass image; past
    --max-retries the run fails with TileRenderError, and the same command
    without the fault resumes from --checkpoint to the same image."""
    from cpu_path_tracing_tpu_torch.orchestrator import TileRenderError, TileState

    args = ["render", "--scene", "box", *SMALL]
    one, tiled, resumed = (str(tmp_path / n) for n in ("one.png", "tiled.png", "resumed.png"))
    assert cli.main([*args, "-o", one]) == 0
    assert cli.main([*args, "-o", tiled, "--tile-cells", "256", "--inject-fault", "1:2,4"]) == 0
    ck = str(tmp_path / "tiles.npz")
    with pytest.raises(TileRenderError):
        cli.main([*args, "-o", resumed, "--tile-cells", "256", "--checkpoint", ck,
                  "--inject-fault", "3:3", "--max-retries", "2"])
    assert TileState.load(ck).done.tolist() == [True] * 3 + [False] * 3
    assert cli.main([*args, "-o", resumed, "--tile-cells", "256", "--checkpoint", ck]) == 0
    assert TileState.load(ck).done.all()
    ref = open(one, "rb").read()
    assert open(tiled, "rb").read() == ref and open(resumed, "rb").read() == ref


def test_invert_resumes_from_checkpoint(tmp_path, capsys):
    """cli invert --checkpoint: 2 steps, then the same command to 4 steps
    resumes at step 2 and ends where 4 uninterrupted steps end, bitwise; a
    changed --lr refuses the checkpoint."""
    args = ["invert", "--scene", "box", "--width", "8", "--height", "6", "--spp", "1",
            "--max-depth", "6", "--fields", "albedo,emission", "--device", "cpu",
            "--cell-chunk", "96"]
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert cli.main([*args, "--steps", "4", "--checkpoint", a]) == 0
    assert cli.main([*args, "--steps", "2", "--checkpoint", b]) == 0
    capsys.readouterr()
    assert cli.main([*args, "--steps", "4", "--checkpoint", b, "--save-every", "1"]) == 0
    captured = capsys.readouterr()
    assert f"resumed from {b} at step 2" in captured.err
    steps = [json.loads(ln)["step"] for ln in captured.out.splitlines() if ln.startswith("{")]
    assert steps == [2, 3]
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files) and int(zb["step"]) == 4
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with pytest.raises(ValueError, match="different"):
        cli.main([*args, "--steps", "5", "--checkpoint", b, "--lr", "5e-3"])


def test_debug_nans_flag(tmp_path):
    """--debug-nans passes a clean render, and names the output of a scene
    file whose light is NaN (which renders without the flag)."""
    from cpu_path_tracing_tpu_torch.models.io import save_scene

    out = str(tmp_path / "img.png")
    assert cli.main(["render", "--scene", "box", *SMALL, "-o", out, "--debug-nans"]) == 0
    scene = tp.get_scene("box", 24, 16)
    scene.emission[7] = float("nan")
    spath = str(tmp_path / "nan.json")
    save_scene(spath, scene)
    assert cli.main(["render", "--scene-file", spath, *SMALL, "-o", out]) == 0
    with pytest.raises(FloatingPointError, match="render_cells_range"):
        cli.main(["render", "--scene-file", spath, *SMALL, "-o", out, "--debug-nans"])


@pytest.mark.parametrize("argv", [
    ["render", "--mesh", "2x1"], ["render", "--num-processes", "2"],
    ["invert", "--coordinator", "localhost:1234"], ["bench", "--shard-dir", "x"],
    ["bench", "--scaling"], ["bench", "--ring", "8"],
])
def test_unported_flags_name_their_roadmap_item(argv):
    """Only ``--ring`` is left unported (the port has no result ring); the
    flags of ``parallel/`` parse to what the JAX CLI gives them."""
    if "--ring" in argv:
        with pytest.raises(SystemExit, match="not ported"):
            cli.main([*argv, "--device", "cpu"])
        return
    want = {"mesh": "2x1", "num_processes": 2, "coordinator": "localhost:1234",
            "shard_dir": "x", "scaling": True}
    flag = argv[1].lstrip("-").replace("-", "_")
    assert getattr(cli._parser().parse_args(argv), flag) == want[flag]


def test_bench_suite(tmp_path, capsys, monkeypatch):
    """bench --suite on a shrunk matrix: one JSON record a row and one for
    the inverse step, and the markdown table with a row per scene."""
    import time

    monkeypatch.setattr(cli, "BENCH_MATRIX", (("simple", 16, 12, 16), ("box", 16, 12, 8),
                                              ("random_spheres_512", 16, 12, 4)))
    out = str(tmp_path / "suite.md")
    t0 = time.perf_counter()
    assert cli.main(["bench", "--suite", "--suite-scale", "2", "--repeats", "2", "--suite-out",
                     out, "--device", "cpu"]) == 0
    assert time.perf_counter() - t0 < 30
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    rows, inv = recs[:3], recs[3]
    assert [r["scene"] for r in rows] == ["simple", "box", "random_spheres_512"]
    assert [r["total_spp"] for r in rows] == [8, 4, 4]  # spp / --suite-scale, at least 4
    for r in rows:
        assert r["segments"] > 0 and r["mrays_per_s"] > 0 and r["route"] == "plain"
        assert sum(r["depth_hist"]) == r["camera_rays"] // r["total_spp"] * 4
        assert r["k2_launches"] == 0 and r["device"] == "cpu"
        assert set(r["depth_percentiles"]) == {"p50", "p90", "p99"}
    assert inv["steps_per_s"] > 0 and inv["loss_end"] < inv["loss_start"]
    assert len(inv["steps_per_s_windows"]) == 2 and inv["steps_per_s"] == max(
        inv["steps_per_s_windows"])
    text = open(out).read()
    table = [ln for ln in text.splitlines() if ln.startswith("| ")]
    assert text.startswith("# Benchmark suite — cpu") and len(table) == 1 + 3
