"""Why the port's float32 renders part from the JAX package's on the CPU: the
witness behind the XLA flag of ``scripts/torch_smoke_refs.py``.

    python scripts/torch_smoke_witness.py [--scenes a,b,...] [--out FILE]

For each scene (default: every registered one) the JAX XLA wavefront render
at the gate's config (96x64, 4 samples a cell, max_depth 8 and 100, as
``torch_smoke_refs.scene_refs`` makes it), in three JAX processes:

* ``default``: XLA's CPU backend as it starts (it fuses ``x*a+b`` into one
  FMA where the CPU has it);
* ``no_fma``: ``XLA_FLAGS=--xla_cpu_max_isa=AVX``, the references' backend;
* ``precise_functions``: the default backend with ``jax.lax.rsqrt``,
  ``jnp.sin``, ``jnp.cos`` and ``jnp.tan`` replaced, for float32, by
  correctly rounded ones (computed in float64, rounded once; ``rsqrt`` as
  the port's ``1/sqrt``, two roundings).

Then the port's batch route in float32 on the CPU over every cell, held to
each render by ``utils/parity.pin_gate`` and ``tier1`` (one JSON line a
scene, variant and depth), and each process's probe of its backend on
65,536 seeded inputs: the share of ``x*a+b`` equal to the twice-rounded
result and of ``sqrt``, ``rsqrt``, ``sin`` and ``cos`` equal to the
correctly rounded one.  Imports the JAX package in its child processes
only.  Takes about 6.5 minutes on 8 CPU cores (random_spheres_512's port
render most of it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"default": "", "no_fma": "--xla_cpu_max_isa=AVX", "precise_functions": ""}


def _probe(jax) -> dict:
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x, a, b = (rng.normal(size=1 << 16).astype(np.float32) for _ in range(3))
    fused = np.asarray(jax.jit(lambda x, a, b: x * a + b)(x, a, b))
    out = {"x*a+b twice rounded": float((fused == x * a + b).mean())}
    v = np.abs(x) + np.float32(0.1)
    v64 = v.astype(np.float64)
    for name, fn, want in (("sqrt", jnp.sqrt, np.sqrt(v64)), ("rsqrt", jax.lax.rsqrt,
                                                               1.0 / np.sqrt(v64)),
                           ("sin", jnp.sin, np.sin(v64)), ("cos", jnp.cos, np.cos(v64))):
        got = np.asarray(jax.jit(fn)(v))
        out[f"{name} correctly rounded"] = float((got == want.astype(np.float32)).mean())
    return out


def _precise_functions(jax) -> None:
    import jax.numpy as jnp

    f32, f64 = jnp.float32, jnp.float64

    def once(fn):
        def g(x, *args, **kwargs):
            x = jnp.asarray(x)
            return fn(x.astype(f64)).astype(f32) if x.dtype == f32 else fn(x, *args, **kwargs)
        return g

    rsqrt = jax.lax.rsqrt

    def port_rsqrt(x):
        x = jnp.asarray(x)
        if x.dtype != f32:
            return rsqrt(x)
        return (1.0 / jnp.sqrt(x.astype(f64)).astype(f32).astype(f64)).astype(f32)

    jax.lax.rsqrt = port_rsqrt
    jnp.sin, jnp.cos, jnp.tan = once(jnp.sin), once(jnp.cos), once(jnp.tan)


def child(variant: str, scenes: list, path: str) -> None:
    """One JAX process: the renders of ``scenes`` and the probe, to ``path``."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_smoke_refs as refs

    refs.REQUIRE_NO_FMA = variant == "no_fma"
    jax = refs._jax()
    if variant == "precise_functions":
        _precise_functions(jax)
    out = {"probe": json.dumps(_probe(jax))}
    for name in scenes:
        for key, sums in refs.scene_refs(name).items():
            out[f"{name}.{key}"] = sums
    np.savez(path, **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", default="", help="comma-separated; default every scene")
    ap.add_argument("--out", default="", help="also write the JSON lines here")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--npz", default="", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    if a.child:
        child(a.child, a.scenes.split(","), a.npz)
        return 0

    import torch

    import cpu_path_tracing_tpu_torch as tp
    from cpu_path_tracing_tpu_torch.render import render_batch
    from cpu_path_tracing_tpu_torch.utils import parity

    scenes = a.scenes.split(",") if a.scenes else tp.scene_names()
    lines = []

    def emit(rec):
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    with tempfile.TemporaryDirectory(prefix="torch_smoke_witness_") as work:
        procs = {}
        for variant, flags in VARIANTS.items():
            env = {**os.environ, "JAX_PLATFORMS": "cpu",
                   "XLA_FLAGS": f"--xla_force_host_platform_device_count=8 {flags}".strip()}
            path = os.path.join(work, f"{variant}.npz")
            procs[variant] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", variant, "--scenes",
                 ",".join(scenes), "--npz", path], env=env), path)
        port = {}
        for name in scenes:
            scene = tp.get_scene(name, 96, 64)
            for depth in (8, 100):
                cfg = tp.RenderConfig(width=96, height=64, spp=4, max_depth=depth)
                port[(name, depth)] = render_batch(scene, cfg, torch.arange(cfg.num_cells), 0,
                                                   4).numpy()
        for variant, (proc, path) in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"the {variant} JAX process failed")
            with np.load(path) as z:
                emit({"variant": variant, "flags": VARIANTS[variant],
                      "probe": json.loads(str(z["probe"]))})
                for (name, depth), got in port.items():
                    ref = z[f"{name}.d{depth}"]
                    gate, t1 = parity.pin_gate(got, ref), parity.tier1(got, ref)
                    emit({"variant": variant, "scene": name, "max_depth": depth,
                          "frac_above_1e-4": gate["frac_above_1e-4"],
                          "channel_ratios": gate["channel_ratios"], "pin_gate_ok": gate["ok"],
                          "p999": t1["p999"], "exact_frac": t1["exact_frac"]})
    if a.out:
        with open(a.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
