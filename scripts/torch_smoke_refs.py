"""Write the JAX package's reference renders that ``scripts/torch_smoke.py``
holds the port to.

    JAX_PLATFORMS=cpu python scripts/torch_smoke_refs.py [--out DIR]

Runs on the CPU and imports the JAX package (a script, like the tests, not a
module of the port).  It writes ``tests/data/smoke/``:

* ``<scene>_96x64.npz`` for each of ``cpu_path_tracing_tpu.scene_names()``:
  ``d8`` and ``d100``, the XLA wavefront render (``render_wavefront`` with
  ``wavefront_lanes=1 << 16``, as ``scripts/tpu_smoke.py`` calls it) at
  max_depth 8 and 100, 96x64 at 4 samples a cell, ``RenderConfig``'s
  default seed and jitter: [cells, 3] float32 per-cell sums in the order of
  ``render_cells_range`` (cell ids 0..cells-1).  ``d100`` is stored as its
  bits XOR ``d8``'s (``d100_xor_d8``, uint32; ``scripts/torch_smoke.py``'s
  ``load_scene_refs`` decodes it): most paths end before bounce 8, so the
  XOR is mostly 0 and the twelve files take 1.7 MB, not 2.8.  Beside them
  ``f64_d100``, the batch route's sums in float64 at max_depth 100 over 256
  cells spread over the image (``f64_ids``): in float64 the two packages
  take the same decision at every branch, so the port is held to them
  within 1e-9;
* ``replay_box_96x64.npz``: the gradients of ``sum(ct * sums)`` on box at
  max_depth 100 with respect to albedo, emission and background, by
  ``replay_param_grads_wavefront``, with ``scripts/tpu_smoke.py``'s seeded
  cotangent ``ct = default_rng(7).normal(0, 0.01, (cells, 3))``;
* ``geometry_simple_96x64.npz``: the same contraction's gradients on simple
  at max_depth 100 with respect to p0, radius and the camera's eight
  fields (``camera.<field>``), by ``jax.grad`` of the JAX package's
  contracted render (``grad._contracted_render_sum``: the scan loop, each
  bounce rematerialized, no compaction), the same seeded cotangent.
  Beside them, in float64 over every ``F64_GROUP_STRIDE``-th group of
  cells (``f64_groups``), the same gradients (``f64.p0``, ``f64.radius``,
  ``f64.camera.<field>``), to which the port's float64 plain geometry
  route is held within 1e-9.

Both gradient files hold one row a group of 96 contiguous cells
([groups, ...]), the sums of ``jax.grad`` over those cells.

Each file also holds ``config``, (width, height, samples a cell).

Everything but the float64 references is float32 (``get_scene(...,
dtype=float32)``, int32 cell ids) with x64 switched on, as
``tests/conftest.py`` runs JAX, so that a test regenerates a file bit for
bit.

XLA's CPU compiler lets LLVM fuse ``x*a+b`` into one FMA wherever the
target has it; the port builds its kernels with ``-fmad=false`` and its
plain versions run one PyTorch op at a time, so each product rounds before
the sum.  In float32 that one rounding turns the nearest-hit choice among
random_spheres' 100 small spheres on 4% of its cells.  So the JAX backend
here runs with ``--xla_cpu_max_isa=AVX`` (``NO_FMA_FLAG``: no FMA
instruction, so no fusion; set before JAX starts, and checked by
``check_no_fma``): the JAX package's own code, rounded as the port rounds
every product.  Its ``rsqrt``, ``sin`` and ``cos`` still differ from the
port's by an ulp on a few percent of inputs.  The whole set takes about 2
minutes on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "smoke")
WIDTH, HEIGHT, SPP = 96, 64, 4
DEPTHS = (8, 100)
CT_SEED, CT_SCALE = 7, 0.01
# Gradient references a group of contiguous cells at a time (96 cells, 24
# pixels, at 96x64): the float64 reference takes a few of the groups.
GROUPS = 256
# Cells of the float64 reference: spread over the image.
F64_CELLS = 256
GEOMETRY_FIELDS = ("p0", "radius", "camera")
# Groups of the float64 geometry reference: every 16th, 16 in all.
F64_GROUP_STRIDE = 16
NO_FMA_FLAG = "--xla_cpu_max_isa=AVX"
# ``_jax`` raises unless the backend keeps x*a+b apart (``check_no_fma``);
# only ``scripts/torch_smoke_witness.py`` turns it off, to render otherwise.
REQUIRE_NO_FMA = True


def cotangent(n_cells: int) -> np.ndarray:
    """The seeded cotangent of the replay and geometry references."""
    return np.random.default_rng(CT_SEED).normal(0, CT_SCALE, (n_cells, 3)).astype(np.float32)


def use_no_fma_backend() -> None:
    """Put ``NO_FMA_FLAG`` (and 8 host devices, as the tests run JAX) into
    ``XLA_FLAGS``; it takes effect only if JAX's CPU backend has not
    started in this process."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    if NO_FMA_FLAG not in flags:
        flags += f" {NO_FMA_FLAG}"
    os.environ["XLA_FLAGS"] = flags.strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")


def check_no_fma(jax) -> None:
    """Raise unless the backend rounds ``x*a+b``'s product before the sum."""
    rng = np.random.default_rng(0)
    x, a, b = (rng.normal(size=4096).astype(np.float32) for _ in range(3))
    got = np.asarray(jax.jit(lambda x, a, b: x * a + b)(x, a, b))
    if not np.array_equal(got, x * a + b):
        raise RuntimeError(f"JAX's CPU backend fuses x*a+b: start it with XLA_FLAGS={NO_FMA_FLAG} "
                           "(use_no_fma_backend() before JAX starts)")


def _jax():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if REQUIRE_NO_FMA:
        check_no_fma(jax)
    return jax


def scene_refs(name: str, width: int = WIDTH, height: int = HEIGHT, spp: int = SPP,
               depths=DEPTHS) -> dict:
    """{"d8": ..., "d100": ...}: the JAX XLA wavefront render's per-cell
    sums [cells, 3] float32 at each max_depth."""
    jax = _jax()
    import jax.numpy as jnp

    import cpu_path_tracing_tpu as pt
    from cpu_path_tracing_tpu.ops.wavefront import render_wavefront

    scene = pt.get_scene(name, width, height, dtype=jnp.float32)
    out = {}
    for depth in depths:
        cfg = pt.RenderConfig(width=width, height=height, spp=spp, max_depth=depth,
                              wavefront_lanes=1 << 16)
        ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
        sums = jax.jit(lambda s, i, cfg=cfg: render_wavefront(s, cfg, i, 0, spp))(scene, ids)
        out[f"d{depth}"] = np.asarray(sums, dtype=np.float32)
    return out


def f64_ids(n_cells: int, count: int = F64_CELLS) -> np.ndarray:
    """The cells of the float64 reference, ``count`` spread over the image."""
    return np.unique(np.linspace(0, n_cells - 1, count).round().astype(np.int32))


def f64_refs(name: str, width: int = WIDTH, height: int = HEIGHT, spp: int = SPP) -> dict:
    """{"f64_ids", "f64_d100"}: the JAX batch route in float64 at max_depth
    100 over ``f64_ids``' cells, [cells, 3] sums."""
    jax = _jax()
    import jax.numpy as jnp

    import cpu_path_tracing_tpu as pt
    from cpu_path_tracing_tpu.render import render_cells_range

    scene = pt.get_scene(name, width, height, dtype=jnp.float64)
    cfg = pt.RenderConfig(width=width, height=height, spp=spp, max_depth=100, integrator="batch")
    ids = f64_ids(cfg.num_cells)
    sums = jax.jit(lambda s, i: render_cells_range(s, cfg, i, 0, spp))(scene, jnp.asarray(ids))
    return {"f64_ids": ids, "f64_d100": np.asarray(sums, dtype=np.float64)}


def _group_spans(n_cells: int, groups: int = GROUPS):
    per = n_cells // groups
    return [(g * per, (g + 1) * per) for g in range(groups)]


def replay_refs(width: int = WIDTH, height: int = HEIGHT, spp: int = SPP,
                groups: int = GROUPS) -> dict:
    """Box at max_depth 100: each group's albedo, emission and background
    gradients of ``sum(ct * sums)`` over its cells by the JAX wavefront
    replay, [groups, ...]."""
    jax = _jax()
    import jax.numpy as jnp

    import cpu_path_tracing_tpu as pt
    from cpu_path_tracing_tpu.ops.replay import replay_param_grads_wavefront

    cfg = pt.RenderConfig(width=width, height=height, spp=spp, max_depth=100)
    scene = pt.get_scene("box", width, height, dtype=jnp.float32)
    ct = jnp.asarray(cotangent(cfg.num_cells))
    fn = jax.jit(lambda s, i, c: replay_param_grads_wavefront(s, cfg, i, 0, spp, c))
    parts = [jax.device_get(fn(scene, jnp.arange(a, b, dtype=jnp.int32), ct[a:b]))
             for a, b in _group_spans(cfg.num_cells, groups)]
    out = {k: np.stack([np.asarray(p[k], np.float32) for p in parts])
           for k in ("albedo", "emission", "background")}
    return {**out, "config": np.array((width, height, spp))}


def geometry_refs(width: int = WIDTH, height: int = HEIGHT, spp: int = SPP,
                  groups: int = GROUPS, f64_stride: int = F64_GROUP_STRIDE) -> dict:
    """Simple at max_depth 100: each group's p0, radius and camera gradients
    of ``sum(ct * sums)`` over its cells by ``jax.grad`` of the contracted
    render, [groups, ...] float32; and in float64 those of every
    ``f64_stride``-th group (``f64_groups``), keys prefixed ``f64.``."""
    jax = _jax()
    import jax.numpy as jnp

    import cpu_path_tracing_tpu as pt
    from cpu_path_tracing_tpu import grad as jgrad

    cfg = pt.RenderConfig(width=width, height=height, spp=spp, max_depth=100, loop="scan",
                          integrator="batch", remat=True)
    spans = _group_spans(cfg.num_cells, groups)
    f64_groups = np.arange(0, groups, f64_stride)
    out = {"f64_groups": f64_groups, "config": np.array((width, height, spp))}
    for prefix, dtype, picked in (("", jnp.float32, range(groups)),
                                  ("f64.", jnp.float64, f64_groups)):
        scene = pt.get_scene("simple", width, height, dtype=dtype)
        ct = jnp.asarray(cotangent(cfg.num_cells), dtype=dtype)

        def contracted(params, ids, c, scene=scene):
            return jgrad._contracted_render_sum(jgrad.merge_params(scene, params), cfg, ids, 0,
                                                spp, c)

        fn = jax.jit(jax.grad(contracted))
        params = jgrad.split_params(scene, GEOMETRY_FIELDS)
        parts = []
        for g in picked:
            a, b = spans[g]
            parts.append(jax.device_get(fn(params, jnp.arange(a, b, dtype=jnp.int32), ct[a:b])))
        np_dt = np.dtype(dtype)
        out[f"{prefix}p0"] = np.stack([np.asarray(p["p0"], np_dt) for p in parts])
        out[f"{prefix}radius"] = np.stack([np.asarray(p["radius"], np_dt) for p in parts])
        for f in ("position", "look_at", "up", "aspect_ratio", "vertical_fov_radians",
                  "aperture", "focus_distance", "origin_advance"):
            out[f"{prefix}camera.{f}"] = np.stack([np.asarray(getattr(p["camera"], f), np_dt)
                                                   for p in parts])
    return out


def scene_path(name: str, out_dir: str = OUT) -> str:
    return os.path.join(out_dir, f"{name}_{WIDTH}x{HEIGHT}.npz")


def write_scene_refs(path: str, refs: dict, config=(WIDTH, HEIGHT, SPP)) -> None:
    """``scene_refs`` and ``f64_refs`` of one scene in one file."""
    bits8 = refs["d8"].view(np.uint32)
    np.savez_compressed(path, d8=refs["d8"], d100_xor_d8=refs["d100"].view(np.uint32) ^ bits8,
                        f64_ids=refs["f64_ids"], f64_d100=refs["f64_d100"],
                        config=np.array(config))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT, help="directory of the .npz files")
    a = ap.parse_args(argv)
    use_no_fma_backend()
    _jax()
    import cpu_path_tracing_tpu as pt

    os.makedirs(a.out, exist_ok=True)
    t_all = time.perf_counter()
    for name in pt.scene_names():
        t0 = time.perf_counter()
        write_scene_refs(scene_path(name, a.out), {**scene_refs(name), **f64_refs(name)})
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    for fname, fn in ((f"replay_box_{WIDTH}x{HEIGHT}.npz", replay_refs),
                      (f"geometry_simple_{WIDTH}x{HEIGHT}.npz", geometry_refs)):
        t0 = time.perf_counter()
        np.savez_compressed(os.path.join(a.out, fname), **fn())
        print(f"{fname}: {time.perf_counter() - t0:.1f} s", flush=True)
    total = sum(os.path.getsize(os.path.join(a.out, f)) for f in os.listdir(a.out))
    print(f"wrote {a.out}: {total} bytes in all, {time.perf_counter() - t_all:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
