"""The port's parity gate on the CPU: ``utils/parity.py``, the committed JAX
references of ``scripts/torch_smoke.py`` and the gate's resume and exit.

* ``scale_aware`` against the JAX gate's own formula
  (``scripts/tpu_smoke.py::_scale_aware``), and ``tier1``, ``tier2`` and
  ``pin_gate`` on crafted cases that pass and fail.
* ``scripts/torch_smoke_refs.py`` reproduces the committed ``simple`` render
  at max_depth 8 bit for bit, in a process of its own whose JAX backend
  does not fuse ``x*a+b`` (as the generator runs it); the committed files
  stay under 2 MB.
* Every scene's batch route on 512 cells spread over the image against the
  committed JAX ``d8`` render by ``pin_gate``, and in float64 against the
  committed JAX float64 render at max_depth 100, within 1e-9.
* The gradient sections scale each sphere's row and each camera field by
  its own largest magnitude.
* ``run(..., device="cpu")`` on references made at 16x12, 1 sample a cell:
  writes the artifact, skips the rows its state file says passed, returns 1
  when a render reference is corrupted and when one camera field of the
  geometry reference is 1% off.
* Importing ``scripts/torch_smoke.py`` does not import JAX.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch.render import render_batch
from cpu_path_tracing_tpu_torch.utils import parity

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_DATA = os.path.join(REPO, "tests", "data", "smoke")
W, H, SPP = 96, 64, 4
TINY = (16, 12, 1)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load("torch_smoke")


@pytest.fixture(scope="module")
def refs_gen():
    return _load("torch_smoke_refs")


@pytest.mark.parametrize("dtype", [np.float32, np.float64, "tensor"])
def test_scale_aware_matches_the_jax_gate(dtype):
    jax_gate = _load("tpu_smoke")
    rng = np.random.default_rng(3)
    a = rng.normal(0, 2, (400, 3)) * (rng.random((400, 3)) < 0.7)  # zeros and values under 1
    b = a + rng.normal(0, 1e-3, a.shape) * (rng.random(a.shape) < 0.5)
    b[:10] = 0.0
    want = jax_gate._scale_aware(a.astype(np.float64), b.astype(np.float64))
    if dtype == "tensor":
        got = parity.scale_aware(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    else:
        got = parity.scale_aware(a.astype(dtype), b.astype(dtype))
        want = jax_gate._scale_aware(a.astype(dtype), b.astype(dtype))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _items(n=10_000, seed=4):
    return np.random.default_rng(seed).uniform(0.1, 3.0, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("flipped,off,ok", [(0, 0.0, True), (5, 1e-2, True), (20, 1e-2, False),
                                            (200, 2e-5, False)])
def test_tier1_counts_items_by_their_worst_channel(flipped, off, ok):
    ref = _items()
    got = ref.copy()
    got[:flipped, 1] += off * np.maximum(np.abs(ref[:flipped, 1]), 1.0)
    rec = parity.tier1(got, ref)
    assert rec["ok"] is ok
    assert rec["frac_above_1e-3"] == pytest.approx(flipped / ref.shape[0] if off > 1e-3 else 0.0)
    assert rec["exact_frac"] == pytest.approx(1.0 - flipped / ref.size)
    # The kernels' [3, items] layout with the channel axis 0 reads the same.
    assert parity.tier1(got.T, ref.T, axis=0) == rec


@pytest.mark.parametrize("case,ok", [("same_estimator", True), ("biased_channel", False),
                                     ("decorrelated", False)])
def test_tier2_against_the_seed_yardstick(case, ok):
    rng = np.random.default_rng(5)
    truth = _items(20_000)
    ref = truth * rng.exponential(1.0, truth.shape)  # one realization of the estimator
    alt = truth * rng.exponential(1.0, truth.shape)  # an independent one
    got = ref.copy()
    flip = rng.random(truth.shape[0]) < 0.01  # 1% of the paths took another branch
    got[flip] = alt[flip]
    if case == "biased_channel":
        got[:, 2] *= 1.02
    elif case == "decorrelated":
        got = truth * rng.exponential(1.0, truth.shape) ** 2
    rec = parity.tier2(got, ref, alt)
    assert rec["ok"] is ok, rec
    assert rec["seed_yardstick"] > 0.1 and len(rec["channel_ratios"]) == 3


@pytest.mark.parametrize("share,mean_shift,tol,ok", [(0.005, 0.0, 0.01, True),
                                                     (0.02, 0.0, 0.01, False),
                                                     (0.005, 0.007, 0.01, True),
                                                     (0.005, 0.007, 0.005, False)])
def test_pin_gate(share, mean_shift, tol, ok):
    ref = _items().reshape(100, 100, 3)
    got = ref.copy()
    n = int(share * 10_000)
    # n pixels off in channel 0, carrying mean_shift of its sum between them
    got.reshape(-1, 3)[:n, 0] += max(1e-3, mean_shift * float(ref[..., 0].sum()) / n)
    rec = parity.pin_gate(got, ref, mean_tol=tol)
    assert rec["ok"] is ok, rec
    assert rec["frac_above_1e-4"] == pytest.approx(share)
    assert rec["channel_ratios"][0] == pytest.approx(1.0 + mean_shift, abs=1e-4)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """One process of the generator's backend: ``simple``'s render at
    max_depth 8 at the committed size (``simple_d8.npy``), and references at
    16x12, 1 sample a cell, 4 gradient groups, the float64 geometry one on
    groups 0 and 2 (``tiny/``)."""
    out = tmp_path_factory.mktemp("generated")
    code = f"""
import sys
import numpy as np
sys.path.insert(0, "scripts")
import torch_smoke_refs as g
g.use_no_fma_backend()
np.save({str(out / "simple_d8.npy")!r}, g.scene_refs("simple", depths=(8,))["d8"])
w, h, spp = {TINY}
for name in ("depth_of_field", "box", "simple"):
    g.write_scene_refs(f"{out}/tiny/{{name}}_{{w}}x{{h}}.npz",
                       {{**g.scene_refs(name, w, h, spp), **g.f64_refs(name, w, h, spp)}}, {TINY})
np.savez_compressed(f"{out}/tiny/replay_box_{{w}}x{{h}}.npz", **g.replay_refs(w, h, spp, groups=4))
np.savez_compressed(f"{out}/tiny/geometry_simple_{{w}}x{{h}}.npz",
                    **g.geometry_refs(w, h, spp, groups=4, f64_stride=2))
"""
    (out / "tiny").mkdir()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True)
    return out


def test_refs_regenerate_bitwise(generated, refs_gen, smoke):
    """The generator reproduces the committed ``simple`` render at max_depth
    8 bit for bit (the JAX package on the CPU, float32, x64 on)."""
    got = np.load(generated / "simple_d8.npy")
    ref = smoke.load_scene_refs(os.path.join(SMOKE_DATA, f"simple_{W}x{H}.npz"), (W, H, SPP))
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32),
                                                      ref["d8"].view(np.uint32))
    assert np.array_equal(refs_gen.cotangent(97), smoke.cotangent(97))  # the two copies agree
    total = sum(os.path.getsize(os.path.join(SMOKE_DATA, f)) for f in os.listdir(SMOKE_DATA))
    assert total < 2 << 20 and len(os.listdir(SMOKE_DATA)) == len(tp.scene_names()) + 2


def _spread(n_cells, count=512):
    return torch.from_numpy(np.unique(np.linspace(0, n_cells - 1, count).round().astype(np.int64)))


@pytest.mark.parametrize("name", tp.scene_names())
def test_batch_route_matches_jax_d8(smoke, name):
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=8)
    ids = _spread(cfg.num_cells)
    ref = smoke.load_scene_refs(os.path.join(SMOKE_DATA, f"{name}_{W}x{H}.npz"), (W, H, SPP))
    got = render_batch(tp.get_scene(name, W, H), cfg, ids, 0, SPP).numpy()
    rec = parity.pin_gate(got, ref["d8"][ids.numpy()])
    assert rec["ok"], rec


@pytest.mark.parametrize("name", tp.scene_names())
def test_batch_route_float64_matches_jax_d100(smoke, name):
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=100)
    ref = smoke.load_scene_refs(os.path.join(SMOKE_DATA, f"{name}_{W}x{H}.npz"), (W, H, SPP))
    got = render_batch(tp.get_scene(name, W, H, dtype=torch.float64), cfg,
                       torch.from_numpy(ref["f64_ids"]), 0, SPP).numpy()
    assert float(parity.scale_aware(got, ref["f64_d100"]).max()) < smoke.F64_TOL


def test_gradient_rows_are_scaled_on_their_own(smoke):
    """A field or a sphere whose gradient is small beside the others is held
    on its own scale, down to the floor."""
    ref = {"p0": np.array([[10.0, 0, 0], [0.01, 0.02, 0]]), "camera.aperture": np.array(0.5),
           "camera.origin_advance": np.array(1e-7)}
    got = {"p0": torch.tensor([[10.0, 0, 0], [0.0101, 0.02, 0]]),
           "camera.aperture": torch.tensor(0.505), "camera.origin_advance": torch.tensor(3e-7)}
    devs = smoke._row_devs(got, ref, ("p0",), 1e-2)
    assert devs["p0"] == pytest.approx(0.0001 / 0.1, rel=1e-4)  # sphere 2, on the floor 0.1
    assert devs["camera.aperture"] == pytest.approx(0.01, rel=1e-5)
    assert devs["camera.origin_advance"] == pytest.approx(2e-7 / 0.1, rel=1e-5)
    whole = smoke._row_devs(got, ref)  # no rows, no floor: each field on its largest
    assert whole["p0"] == pytest.approx(1e-5, rel=1e-4)


def test_run_writes_resumes_and_fails_on_a_corrupted_ref(smoke, generated, tmp_path):
    tiny_refs = generated / "tiny"
    w, h, spp = TINY
    state, out = str(tmp_path / "state.json"), str(tmp_path / "TORCH_SMOKE.md")
    seen = []
    kw = dict(width=w, height=h, spp=spp, out_path=out, state_path=state, device="cpu",
              scenes=["depth_of_field"], refs_dir=str(tiny_refs), on_record=seen.append)
    assert smoke.run(**kw) == 0
    text = open(out).read()
    assert text.startswith("# Port on-card parity smoke — CPU") and "| depth_of_field | 5 |" in text
    assert [r.get("section", r.get("scene")) for r in seen] == ["depth_of_field", "sharded",
                                                               "replay", "geometry"]
    assert all(r["ok"] and "cached" not in r for r in seen)
    assert set(json.load(open(state))) == {"config", "scenes", "sharded", "replay", "geometry"}

    seen.clear()  # a rerun skips every row that passed
    assert smoke.run(**kw) == 0
    assert len(seen) == 4 and all(r["cached"] for r in seen) and open(out).read() == text

    bad = tmp_path / "bad_refs"
    shutil.copytree(tiny_refs, bad)
    path = bad / f"depth_of_field_{w}x{h}.npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["d8"] = arrays["d8"] * np.float32(1.5)
    np.savez_compressed(path, **arrays)
    seen.clear()
    assert smoke.run(**{**kw, "state_path": str(tmp_path / "bad.json"),
                        "refs_dir": str(bad)}) == 1
    row = seen[0]
    assert not row["ok"] and not row["d8_k2_vs_jax"]["ok"] and row["within_port_ok"]
    assert "| NO" in open(out).read()

    off = tmp_path / "off_refs"  # one camera field of the geometry reference 1% off
    shutil.copytree(tiny_refs, off)
    path = off / f"geometry_simple_{w}x{h}.npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["camera.aperture"] = arrays["camera.aperture"] * np.float32(1.01)
    np.savez_compressed(path, **arrays)
    seen.clear()
    assert smoke.run(**{**kw, "state_path": str(tmp_path / "off.json"),
                        "refs_dir": str(off)}) == 1
    geo = seen[-1]
    assert geo["section"] == "geometry" and not geo["ok"] and geo["f64"]["ok"]
    assert [k for k, v in geo["fields"].items() if v["dev"] >= geo["tol"]] == ["camera.aperture"]


def test_smoke_imports_no_jax():
    code = ("import sys; sys.path.insert(0, 'scripts'); import torch_smoke; "
            "print('jax' in sys.modules, 'cpu_path_tracing_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True).stdout.split()
    assert out == ["False", "False"]


def test_smoke_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "scripts/torch_smoke.py"], cwd=REPO,
                          capture_output=True, text=True)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
