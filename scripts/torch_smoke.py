"""On-card parity gate of the PyTorch + CUDA port, the twin of
``scripts/tpu_smoke.py``: every registered scene of the port held to its own
routes and to the JAX package's renders.

    python scripts/torch_smoke.py [--state FILE] [--out TORCH_SMOKE.md] [--device cuda]

Runs on the card unless ``--device cpu`` is given; without a card it exits
non-zero.  It imports the port, torch and numpy, never JAX.  For each scene
at max_depth 8 and 100, on the same cell ids (every cell of the image, 4
samples a cell, lanes 2^16 for the per-step loops), four routes of the port:

* ``batch``: ``render.render_batch``, the differentiable route;
* plain: ``ops/wavefront.render_wavefront``, the plain step's loop;
* K4: ``render_wavefront_per_step``, the per-step kernel;
* K2: ``render_wavefront_persistent``, the whole-render kernel.

Within the port (as ``scripts/tpu_smoke.py:117-157``): K2 equal to K4 bit for
bit at both depths; the plain route within 2e-5 (scale-aware, max) of batch
at max_depth 8; K4 against the plain route by ``utils/parity.tier1`` at
max_depth 8 and by ``tier2`` at 100 (the yardstick the plain route at seed
1234).  Against the JAX package, from the committed renders
``tests/data/smoke/<scene>_96x64.npz`` (``scripts/torch_smoke_refs.py``):
K2 against the XLA wavefront's ``d8`` by ``parity.pin_gate``, with
``tier1``'s p99.9 and share above 1e-3 beside it, and against its ``d100``
by ``tier2``, the yardstick the port's seed-1234 plain render; and the
port's batch route in float64 at max_depth 100 against the JAX batch route
in float64 on 256 cells, within 1e-9.  In float64 the two packages take the
same decision at every branch.  In float32 the references are made with
XLA's CPU backend kept from fusing ``x*a+b`` into an FMA
(``scripts/torch_smoke_refs.py``), as the port rounds every product; its
``rsqrt``, ``sin`` and ``cos`` still differ from the port's by an ulp on a
few percent of inputs, so a few items take the other branch at a discrete
choice (Schlick, the nearest hit, roulette).

Then three sections, each against the committed JAX references:

* sharded: ``parallel/render.render_cells_sharded`` on box at max_depth 100
  on (1,1) and (2,1) meshes whose entries repeat the one device, each equal
  bit for bit to one ``render_cells``;
* replay: K3 (``replay_param_grads_kernel``) on box at max_depth 100 with the
  seeded cotangent ``default_rng(7).normal(0, 0.01)`` over every cell:
  albedo, emission and background each within 2e-2 of the largest
  magnitude of its JAX gradient (the JAX gate's bar,
  ``scripts/tpu_smoke.py:245``), and two launches bitwise equal;
* geometry: K7 (``geometry_param_grads_kernel``) on simple, the same
  cotangent: each sphere's p0 and radius and each of the camera's eight
  fields within ``GEOMETRY_TOL`` of its own largest magnitude in the
  ``jax.grad`` reference (a row under ``GEOMETRY_FLOOR`` of the section's
  largest magnitude is scaled by that floor: camera.origin_advance's
  gradient is 0 up to rounding), and two launches bitwise equal; and K7's
  plain version in float64 against the JAX float64 gradients of 16 groups
  of 96 cells, each row within 1e-9 on the same scale.

Each scene and section is written to ``--state`` (an atomic replace) as it
ends; a rerun with the same config and device skips the rows that passed.
Writes the artifact ``--out`` (the card's name and power limit from
nvidia-smi in its header) and exits 1 if any row failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import cpu_path_tracing_tpu_torch as tp  # noqa: E402
from cpu_path_tracing_tpu_torch.models.camera import FIELDS as CAMERA_FIELDS  # noqa: E402
from cpu_path_tracing_tpu_torch.ops.geometry_replay import (  # noqa: E402
    geometry_grads_from_partials,
)
from cpu_path_tracing_tpu_torch.ops.kernels.geometry_replay import (  # noqa: E402
    geometry_param_grads_kernel,
    geometry_replay_reference,
)
from cpu_path_tracing_tpu_torch.ops.kernels.megakernel import (  # noqa: E402
    pack_camera,
    pack_scene,
)
from cpu_path_tracing_tpu_torch.ops.kernels.replay import replay_param_grads_kernel  # noqa: E402
from cpu_path_tracing_tpu_torch.ops.wavefront import (  # noqa: E402
    render_wavefront,
    render_wavefront_per_step,
    render_wavefront_persistent,
)
from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from cpu_path_tracing_tpu_torch.parallel.render import render_cells_sharded  # noqa: E402
from cpu_path_tracing_tpu_torch.render import render_batch, render_cells  # noqa: E402
from cpu_path_tracing_tpu_torch.utils import parity  # noqa: E402

REFS = os.path.join(REPO, "tests", "data", "smoke")
OUT = os.path.join(REPO, "TORCH_SMOKE.md")
LANES = 1 << 16
WAVEFRONT_VS_BATCH = 2e-5
REPLAY_TOL = 2e-2
# K7 against the float32 jax.grad reference, each row on its own scale: the
# plain version of K7 on the CPU reads at most 2.7e-4 (camera.aperture, whose
# contributions cancel to 1.5% of the largest gradient; p0 8.2e-5; PERF.md,
# Findings PR 12), and K7 agrees with its plain version to 1.2e-6 of the
# largest (PERF.md section 5), up to 8e-5 more on aperture's scale.
GEOMETRY_TOL = 1e-3
GEOMETRY_FLOOR = 1e-2
ALT_SEED = 1234
F64_TOL = 1e-9


def cotangent(n_cells: int) -> np.ndarray:
    """The seeded cotangent of the replay and geometry sections."""
    return np.random.default_rng(7).normal(0, 0.01, (n_cells, 3)).astype(np.float32)


def _load(path: str, config) -> dict:
    with np.load(path) as z:
        refs = {k: z[k] for k in z.files}
    if tuple(int(v) for v in refs.pop("config")) != tuple(config):
        raise ValueError(f"{path} holds another config than (width, height, spp) = {config}")
    return refs


def load_scene_refs(path: str, config) -> dict:
    """A scene's JAX renders: "d8" and "d100" ([cells, 3] float32; ``d100``
    is stored as its bits XOR ``d8``'s), and "f64_d100" ([cells, 3]
    float64 over the cells "f64_ids")."""
    refs = _load(path, config)
    d8 = refs["d8"]
    return {"d8": d8, "d100": (d8.view(np.uint32) ^ refs["d100_xor_d8"]).view(np.float32),
            "f64_ids": refs["f64_ids"].astype(np.int64), "f64_d100": refs["f64_d100"]}


def card_name(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or a note that the
    run is on the CPU."""
    if device.type != "cuda":
        return "CPU (no card: a rehearsal of the gate, not the gate)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[device.index or 0]


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def scene_row(name: str, width: int, height: int, spp: int, refs: dict,
              device: torch.device) -> dict:
    """The four routes at max_depth 8 and 100 and their checks."""
    t0 = time.perf_counter()
    scene = tp.get_scene(name, width, height).to(device)
    base = tp.RenderConfig(width=width, height=height, spp=spp, wavefront_lanes=LANES)
    ids = torch.arange(base.num_cells, device=device)
    rec = {"scene": name, "spheres": scene.num_spheres}
    ok = True
    for depth in (8, 100):
        cfg = base.replace(max_depth=depth)
        args = (scene, cfg, ids, 0, spp)
        batch = _host(render_batch(*args))
        plain = _host(render_wavefront(*args))
        k4 = render_wavefront_per_step(*args)
        k2, stats = render_wavefront_persistent(*args, with_stats=True)
        d = f"d{depth}"
        rec[f"{d}_k2_eq_k4"] = bool(torch.equal(k2, k4))
        rec[f"{d}_plain_vs_batch_max"] = float(parity.scale_aware(plain, batch).max())
        rec[f"{d}_segments"] = int(stats["segments"])
        k2, k4, jax_ref = _host(k2), _host(k4), refs[d]
        if depth == 8:
            rec["d8_k4_vs_plain"] = parity.tier1(k4, plain)
            t1 = parity.tier1(k2, jax_ref)
            rec["d8_k2_vs_jax"] = {**parity.pin_gate(k2, jax_ref), "p999": t1["p999"],
                                   "frac_above_1e-3": t1["frac_above_1e-3"],
                                   "exact_frac": t1["exact_frac"]}
            ok = ok and rec["d8_plain_vs_batch_max"] < WAVEFRONT_VS_BATCH
        else:
            alt = _host(render_wavefront(scene, cfg.replace(seed=ALT_SEED), ids, 0, spp))
            rec["d100_k4_vs_plain"] = parity.tier2(k4, plain, alt)
            rec["d100_k2_vs_jax"] = parity.tier2(k2, jax_ref, alt)
        ok = ok and rec[f"{d}_k2_eq_k4"] and rec[f"{d}_k4_vs_plain"]["ok"]
    scene64 = tp.get_scene(name, width, height, dtype=torch.float64).to(device)
    got64 = render_batch(scene64, base.replace(max_depth=100),
                         torch.from_numpy(refs["f64_ids"]).to(device), 0, spp)
    rec["f64_d100"] = {"cells": int(refs["f64_ids"].size),
                       "max_dev": float(parity.scale_aware(_host(got64), refs["f64_d100"]).max())}
    rec["f64_d100"]["ok"] = rec["f64_d100"]["max_dev"] < F64_TOL
    rec["within_port_ok"] = bool(ok)
    rec["jax_float32_ok"] = rec["d8_k2_vs_jax"]["ok"] and rec["d100_k2_vs_jax"]["ok"]
    rec["ok"] = bool(ok and rec["jax_float32_ok"] and rec["f64_d100"]["ok"])
    rec["seconds"] = time.perf_counter() - t0
    return rec


def sharded_section(width: int, height: int, spp: int, device: torch.device) -> dict:
    cfg = tp.RenderConfig(width=width, height=height, spp=spp, max_depth=100,
                          wavefront_lanes=LANES)
    scene = tp.get_scene("box", width, height).to(device)
    ref = render_cells(scene, cfg, torch.arange(cfg.num_cells, device=device))
    rec = {"section": "sharded", "scene": "box", "max_depth": 100, "meshes": []}
    for n_tiles in (1, 2):
        got = render_cells_sharded(scene, cfg, make_mesh(n_tiles, 1, [device] * n_tiles))
        rec["meshes"].append({"tiles": n_tiles, "exact": bool(torch.equal(got, ref))})
    rec["ok"] = all(m["exact"] for m in rec["meshes"])
    return rec


def _row_devs(got: dict, refs: dict, per_row=(), floor_share: float = 0.0) -> dict:
    """{field: worst |got - ref| over the scale of its row}: the fields in
    ``per_row`` a row (along the first axis: a sphere) at a time, the others
    whole; the scale is the row's largest |ref|, at least ``floor_share`` of
    the largest |ref| of every field."""
    refs = {k: np.asarray(v, np.float64) for k, v in refs.items()}
    floor = floor_share * max(float(np.abs(r).max()) for r in refs.values())
    out = {}
    for k, r in refs.items():
        rows = r.reshape(r.shape[0], -1) if k in per_row else r.reshape(1, -1)
        g = _host(got[k]).astype(np.float64).reshape(rows.shape)
        scale = np.maximum(np.maximum(np.abs(rows).max(axis=1), floor), 1e-300)
        out[k] = float((np.abs(g - rows).max(axis=1) / scale).max())
    return out


def gradient_section(section: str, name: str, grads, refs: dict, n_cells: int, tol: float,
                     device: torch.device, per_row=(), floor_share: float = 0.0) -> dict:
    """A backward kernel's gradients of ``sum(ct * sums)`` over every cell
    against the JAX package's, whose references are kept a group of cells
    at a time ([groups, ...], summed here).  ``grads(ct)`` -> {field:
    tensor}.  Each field within ``tol`` on the scale of ``_row_devs``; two
    launches bitwise equal."""
    ct = torch.from_numpy(cotangent(n_cells)).to(device)
    g1, g2 = (grads(ct) for _ in range(2))
    devs = _row_devs(g1, {k: np.asarray(r, np.float64).sum(axis=0) for k, r in refs.items()},
                     per_row, floor_share)
    rec = {"section": section, "scene": name, "max_depth": 100, "tol": tol,
           "fields": {k: {"dev": devs[k], "bitwise_repeat": bool(torch.equal(g1[k], g2[k]))}
                      for k in refs}}
    rec["ok"] = all(v["dev"] < tol and v["bitwise_repeat"] for v in rec["fields"].values())
    return rec


def replay_section(width: int, height: int, spp: int, refs: dict,
                   device: torch.device) -> dict:
    """K3 on box at max_depth 100: albedo, emission and background."""
    cfg = tp.RenderConfig(width=width, height=height, spp=spp, max_depth=100)
    scene = tp.get_scene("box", width, height).to(device)
    ids = torch.arange(cfg.num_cells, device=device)
    return gradient_section(
        "replay", "box", lambda ct: replay_param_grads_kernel(scene, cfg, ids, 0, spp, ct),
        {k: refs[k] for k in ("albedo", "emission", "background")}, cfg.num_cells, REPLAY_TOL,
        device)


def _geometry_fields(g) -> dict:
    return {"p0": g["p0"], "radius": g["radius"],
            **{f"camera.{f}": getattr(g["camera"], f) for f in CAMERA_FIELDS}}


def geometry_section(width: int, height: int, spp: int, refs: dict,
                     device: torch.device) -> dict:
    """K7 on simple at max_depth 100: p0 and radius per sphere and the
    camera's eight fields; then K7's plain version in float64 on the
    references' ``f64_groups``."""
    cfg = tp.RenderConfig(width=width, height=height, spp=spp, max_depth=100)
    scene = tp.get_scene("simple", width, height).to(device)
    ids = torch.arange(cfg.num_cells, device=device)
    names = ["p0", "radius"] + [f"camera.{f}" for f in CAMERA_FIELDS]
    rec = gradient_section(
        "geometry", "simple",
        lambda ct: _geometry_fields(geometry_param_grads_kernel(scene, cfg, ids, 0, spp, ct)),
        {k: refs[k] for k in names}, cfg.num_cells, GEOMETRY_TOL, device,
        ("p0", "radius"), GEOMETRY_FLOOR)

    f64 = torch.float64
    scene64 = tp.get_scene("simple", width, height, dtype=f64).to(device)
    table, cam = pack_scene(scene64, f64), pack_camera(scene64, f64)
    ct = torch.from_numpy(cotangent(cfg.num_cells)).to(device, f64)
    per = cfg.num_cells // refs["p0"].shape[0]
    got = []
    for g in refs["f64_groups"]:
        a, b = int(g) * per, (int(g) + 1) * per
        part, _ = geometry_replay_reference(table, cam, (a, 0), ct[a:b].contiguous(), cfg=cfg,
                                            n_cells=per, n_items=per * spp, ior=scene64.ior)
        got.append(_geometry_fields(geometry_grads_from_partials(scene64, part)))
    got = {k: torch.stack([g[k] for g in got]) for k in names}

    def rows(k, x):  # a row a group and sphere, or a group and camera field
        return x.reshape(-1, *x.shape[2:]) if k in ("p0", "radius") else x

    devs = _row_devs({k: rows(k, v) for k, v in got.items()},
                     {k: rows(k, refs[f"f64.{k}"]) for k in names}, names, GEOMETRY_FLOOR)
    rec["f64"] = {"groups": int(len(refs["f64_groups"])), "tol": F64_TOL,
                  "max_dev": max(devs.values()), "fields": devs}
    rec["f64"]["ok"] = rec["f64"]["max_dev"] < F64_TOL
    rec["ok"] = rec["ok"] and rec["f64"]["ok"]
    return rec


def _ratios(r) -> str:
    return "/".join(f"{x:.4f}" for x in r["channel_ratios"])


def write_artifact(path: str, header: str, width: int, height: int, spp: int, rows: list,
                   sections: dict) -> None:
    lines = [
        f"# Port on-card parity smoke — {header}",
        "",
        f"Written by `python scripts/torch_smoke.py` ({width}x{height} @ {spp} spp a cell, "
        "float32, every cell).  Within the",
        "port: K2 (whole-render kernel) == K4 (per-step kernel) bit for bit at max_depth 8 and "
        "100; the plain",
        "wavefront within 2e-5 of the batch route at 8; K4 against the plain wavefront by tier 1 "
        "at 8 and",
        "tier 2 at 100 (the yardstick: the plain wavefront at seed 1234).  Against the JAX "
        "package's XLA",
        "wavefront renders (`tests/data/smoke/`, XLA's CPU backend kept from fusing x*a+b): "
        "K2 by the pin",
        "gate at 8 (at most 1% of cells above 1e-4",
        "scale-aware, channel means within 1%; tier 1's p99.9 and share above 1e-3 reported) "
        "and by",
        "tier 2 at 100 (the same yardstick).  In float64 the port's batch route against "
        "the JAX",
        "package's at 100 on 256 cells, within 1e-9 (both take the same decision at every "
        "branch).",
        "`utils/parity.py` holds the rules.",
        "",
        "| scene | spheres | plain vs batch @d8 (max) | K4 vs plain p99.9 @d8 | "
        "K4 flipped frac @d8 | K2 == K4 @d8/@d100 | K4 dev @d100 | seed yardstick @d100 | "
        "K4 ch mean ratios @d100 | JAX @d8: frac > 1e-4 (p99.9, frac > 1e-3) | "
        "JAX @d100: K2 dev / yardstick | JAX @d100 ch ratios | JAX float32 ok | "
        "float64 @d100 (max dev) | ok | s |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        t1, t2 = r["d8_k4_vs_plain"], r["d100_k4_vs_plain"]
        j8, j100 = r["d8_k2_vs_jax"], r["d100_k2_vs_jax"]
        eq = "/".join("yes" if r[f"d{d}_k2_eq_k4"] else "NO" for d in (8, 100))
        lines.append(
            f"| {r['scene']} | {r['spheres']} | {r['d8_plain_vs_batch_max']:.1e} | "
            f"{t1['p999']:.1e} | {t1['frac_above_1e-3']:.1e} | {eq} | {t2['mean_dev']:.2e} | "
            f"{t2['seed_yardstick']:.2e} | {_ratios(t2)} | {j8['frac_above_1e-4']:.2e} "
            f"({j8['p999']:.1e}, {j8['frac_above_1e-3']:.1e}) | {j100['mean_dev']:.2e} / "
            f"{j100['seed_yardstick']:.2e} | {_ratios(j100)} | "
            f"{'yes' if r['jax_float32_ok'] else 'NO'} | {r['f64_d100']['max_dev']:.1e} | "
            f"{'yes' if r['ok'] else 'NO'} | "
            f"{r['seconds']:.1f} |")
    lines.append("")
    sh = sections["sharded"]
    meshes = ", ".join(f"({m['tiles']},1) {'EXACT' if m['exact'] else 'MISMATCH'}"
                       for m in sh["meshes"])
    lines.append(f"Sharded render (`parallel/render.render_cells_sharded`, box at max_depth 100, "
                 f"meshes of the one device, against one `render_cells`): {meshes} -> "
                 f"{'ok' if sh['ok'] else 'FAIL'}.")
    lines.append("")
    rp = sections["replay"]
    fields = ", ".join(f"{k} {v['dev']:.1e}{'' if v['bitwise_repeat'] else ' (NOT bitwise)'}"
                       for k, v in rp["fields"].items())
    lines.append(f"Replay kernel K3 (box at max_depth 100, against the JAX wavefront replay, "
                 f"the seeded cotangent over every cell; each field within {rp['tol']:g} of "
                 f"its largest magnitude; two launches bitwise equal): {fields} -> "
                 f"{'ok' if rp['ok'] else 'FAIL'}.")
    lines.append("")
    g = sections["geometry"]
    fields = ", ".join(f"{k} {v['dev']:.1e}{'' if v['bitwise_repeat'] else ' (NOT bitwise)'}"
                       for k, v in g["fields"].items())
    lines.append(f"Geometry replay kernel K7 (simple at max_depth 100, against `jax.grad` of the "
                 f"JAX contracted render, the same cotangent; each sphere's p0 and radius and "
                 f"each camera field within {g['tol']:g} of its own largest magnitude, at least "
                 f"{GEOMETRY_FLOOR:g} of the section's; two launches bitwise equal): {fields}; "
                 f"K7's plain version in float64 against the JAX float64 gradients of "
                 f"{g['f64']['groups']} groups of cells, the same scale a group: max "
                 f"{g['f64']['max_dev']:.1e} (tol {g['f64']['tol']:g}) -> "
                 f"{'ok' if g['ok'] else 'FAIL'}.")
    lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def _save_state(state_path: str | None, state: dict) -> None:
    if not state_path:
        return
    tmp = state_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(state, fh)
    os.replace(tmp, state_path)


def run(width: int = 96, height: int = 64, spp: int = 4, out_path: str = OUT,
        state_path: str | None = None, device: str = "cuda", scenes=None, refs_dir: str = REFS,
        on_record=None) -> int:
    """The gate: returns 0 if every row passed, else 1.  ``on_record``
    (default: print a JSON line) takes each scene's and section's record as
    it is measured or read back from ``state_path``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass --device cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    on_record = on_record or (lambda r: print(json.dumps(r), flush=True))
    config = (width, height, spp)
    header = card_name(dev)
    state = {}
    if state_path and os.path.exists(state_path):
        with open(state_path) as fh:
            state = json.load(fh)
        if state.get("config") != [*config, dev.type]:
            state = {}
    state["config"] = [*config, dev.type]
    state.setdefault("scenes", {})

    def path(stem):
        return os.path.join(refs_dir, f"{stem}_{width}x{height}.npz")

    def cached(rec):
        on_record({**rec, "cached": True})
        return rec

    rows = []
    for name in scenes or tp.scene_names():
        prev = state["scenes"].get(name)
        if prev and prev["ok"]:
            rows.append(cached(prev))
            continue
        rec = scene_row(name, width, height, spp, load_scene_refs(path(name), config), dev)
        on_record(rec)
        rows.append(rec)
        state["scenes"][name] = rec
        _save_state(state_path, state)

    sections = {}
    for name, fn in (
            ("sharded", lambda: sharded_section(width, height, spp, dev)),
            ("replay", lambda: replay_section(width, height, spp,
                                              _load(path("replay_box"), config), dev)),
            ("geometry", lambda: geometry_section(width, height, spp,
                                                  _load(path("geometry_simple"), config), dev))):
        prev = state.get(name)
        if prev and prev["ok"]:
            sections[name] = cached(prev)
            continue
        t0 = time.perf_counter()
        rec = fn()
        rec["seconds"] = time.perf_counter() - t0
        on_record(rec)
        sections[name] = state[name] = rec
        _save_state(state_path, state)

    write_artifact(out_path, header, width, height, spp, rows, sections)
    failures = sum(not r["ok"] for r in rows) + sum(not s["ok"] for s in sections.values())
    print(f"wrote {out_path}; failures={failures}", file=sys.stderr)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--state", default="", help="per-row state to resume from ('' keeps none)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device: the gate runs on the card (pass --device cpu to rehearse it)",
              file=sys.stderr)
        return 2
    return run(out_path=a.out, state_path=a.state or None, device=a.device)


if __name__ == "__main__":
    raise SystemExit(main())
