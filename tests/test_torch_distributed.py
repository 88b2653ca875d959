"""The port's multi-process rendering (``parallel/distributed.py``, ``cli
render --num-processes``), case for case with ``tests/test_distributed.py``.

* Real 2-process gloo runs of the port's CLI on ``--device cpu``, each rank
  its own OS process joined over a local TCP rendezvous: replicated mode,
  shard mode, and a rank killed before it writes its shard (rank 0
  re-renders its cells).  Each PNG equals the one-process ``cli render``
  PNG byte for byte; a sample-sharded run over the ranks equals ``cli
  render --mesh 1x2`` byte for byte (the same shard sums, added in order).
* Shard files cross the packages: a shard written by the JAX
  ``write_shards`` assembles in the port, and one written by the port in
  the JAX package, to the same image bit for bit; the render fingerprint is
  the JAX one.  A stale shard is rejected, a deleted one re-rendered
  bitwise, a missing one raises.
* One process in a process group of one (``MASTER_ADDR`` and the other
  torch variables): the replicated render and the shard render of the
  whole image equal the one-device render bitwise.
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.parallel import distributed as jax_dist
from cpu_path_tracing_tpu.render import render_cells_range as jax_render_cells_range
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import cli
from cpu_path_tracing_tpu_torch.parallel import distributed as dist_mod
from cpu_path_tracing_tpu_torch.render import finalize_image, render_cells_range
from cpu_path_tracing_tpu_torch.utils.parity import scale_aware

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, DEPTH = 32, 24, 2, 6
RENDER = ["--scene", "box", "--width", str(W), "--height", str(H), "--spp", str(SPP),
          "--max-depth", str(DEPTH), "--device", "cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nprocs: int, extra, tmp_path, expect_rc=None):
    """``nprocs`` ranks of ``cli render``, one OS process each."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    base = [sys.executable, "-m", "cpu_path_tracing_tpu_torch.cli", "render", *RENDER,
            "--num-processes", str(nprocs), "--coordinator", f"127.0.0.1:{port}",
            "-o", str(tmp_path / "image.png"), *extra]
    procs = [subprocess.Popen(base + ["--process-id", str(p)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for p in range(nprocs)]
    expect_rc = expect_rc or {}
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=120)
            want = expect_rc.get(i, 0)
            assert p.returncode == want, f"rank {i} rc={p.returncode}, want {want}:\n{out}\n{err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _cli_png(path, *extra) -> bytes:
    assert cli.main(["render", *RENDER, *extra, "-o", str(path)]) == 0
    return path.read_bytes()


@pytest.fixture(scope="module")
def single_png(tmp_path_factory):
    return _cli_png(tmp_path_factory.mktemp("single") / "image.png")


def test_two_process_replicated_matches_single(single_png, tmp_path):
    _launch(2, [], tmp_path)
    assert (tmp_path / "image.png").read_bytes() == single_png


def test_two_process_sample_sharded_matches_the_in_process_mesh(tmp_path):
    """--mesh 1x2 over two ranks: each renders half of every cell's samples,
    and every rank adds the two halves in order, as the one-process 1x2
    mesh does."""
    _launch(2, ["--mesh", "1x2"], tmp_path)
    ref = _cli_png(tmp_path / "mesh.png", "--mesh", "1x2")
    assert (tmp_path / "image.png").read_bytes() == ref


def test_two_process_shard_mode_matches_single(single_png, tmp_path):
    shard_dir = tmp_path / "shards"
    _launch(2, ["--shard-dir", str(shard_dir)], tmp_path)
    assert (tmp_path / "image.png").read_bytes() == single_png
    assert sorted(os.listdir(shard_dir)) == ["shard_00000.npz", "shard_00001.npz"]


def test_killed_process_recovered_bit_identical(single_png, tmp_path):
    """Rank 1 exits (code 3) after rendering, before its shard is written;
    rank 0 stops waiting after --shard-timeout, publishes LOST_HOSTS,
    re-renders the missing span and writes the one-process image."""
    shard_dir = tmp_path / "shards"
    _launch(2, ["--shard-dir", str(shard_dir), "--inject-shard-loss", "1", "--shard-timeout",
                "3"], tmp_path, expect_rc={1: 3})
    assert (tmp_path / "image.png").read_bytes() == single_png
    assert sorted(os.listdir(shard_dir)) == ["LOST_HOSTS", "shard_00000.npz"]


CFG = tp.RenderConfig(width=8, height=6, spp=2, max_depth=6)
JCFG = pt.RenderConfig(width=8, height=6, spp=2, max_depth=6, integrator="batch")


def _means():
    """The port's cell means of box at CFG (float32) and its image."""
    scene = tp.get_scene("box", CFG.width, CFG.height)
    ids = torch.arange(CFG.num_cells)
    means = render_cells_range(scene, CFG, ids, 0, CFG.spp) / CFG.spp
    return scene, means.numpy(), finalize_image(means, CFG)


def test_render_fingerprint_matches_jax():
    for name in ("box", "box_mirror"):
        assert dist_mod.render_fingerprint(tp.get_scene(name, 8, 6), CFG) == \
            jax_dist.render_fingerprint(pt.get_scene(name, 8, 6), JCFG)
    assert dist_mod.render_fingerprint(tp.get_scene("box", 8, 6), CFG) != \
        dist_mod.render_fingerprint(tp.get_scene("box", 8, 6), CFG.replace(spp=4))


def test_shards_cross_between_the_packages(tmp_path):
    """Half the cells written by each package, in either order of writer:
    each package assembles the two halves to its own one-pass image."""
    scene, means, ref = _means()
    n = CFG.num_cells
    fp = dist_mod.render_fingerprint(scene, CFG)
    mixed = tmp_path / "mixed"
    jax_dist.write_shards(str(mixed), [(0, n // 2, means[:n // 2])], JCFG, 0, fingerprint=fp)
    dist_mod.write_shards(str(mixed), [(n // 2, n, means[n // 2:])], CFG, 1, fingerprint=fp)
    img = dist_mod.assemble_shards(str(mixed), CFG, fingerprint=fp)
    assert torch.equal(img, ref)
    jimg = np.asarray(jax_dist.assemble_shards(str(mixed), JCFG, fingerprint=fp))
    np.testing.assert_array_equal(jimg, np.asarray(pt.render.finalize_image(jnp.asarray(means),
                                                                            JCFG)))
    ported = tmp_path / "ported"
    dist_mod.write_shards(str(ported), [(0, n // 2, means[:n // 2])], CFG, 0, fingerprint=fp)
    dist_mod.write_shards(str(ported), [(n // 2, n, means[n // 2:])], CFG, 1, fingerprint=fp)
    assert sorted(os.listdir(ported)) == sorted(os.listdir(mixed))
    with np.load(ported / "shard_00000.npz") as a, np.load(mixed / "shard_00000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(
        np.asarray(jax_dist.assemble_shards(str(ported), JCFG, fingerprint=fp)), jimg)


def test_assemble_recovers_deleted_shard(tmp_path):
    scene, means, ref = _means()
    n = CFG.num_cells
    dist_mod.write_shards(str(tmp_path), [(0, n // 2, means[:n // 2])], CFG, 0)
    img = dist_mod.assemble_shards(str(tmp_path), CFG, scene=scene)
    assert torch.equal(img, ref)


def test_assemble_detects_missing_shard(tmp_path):
    n = CFG.num_cells
    half = np.zeros((n // 2, 3), np.float32)
    dist_mod.write_shards(str(tmp_path), [(0, n // 2, half)], CFG, 0)
    with pytest.raises(ValueError, match="missing"):
        dist_mod.assemble_shards(str(tmp_path), CFG)
    dist_mod.write_shards(str(tmp_path), [(n // 2, n, half)], CFG, 1)
    assert dist_mod.assemble_shards(str(tmp_path), CFG).shape == (CFG.height, CFG.width, 3)


def test_stale_shards_rejected_by_fingerprint(tmp_path):
    scene, means, ref = _means()
    n = CFG.num_cells
    fp = dist_mod.render_fingerprint(scene, CFG)
    stale_fp = dist_mod.render_fingerprint(scene, CFG.replace(seed=99))
    assert fp != stale_fp
    dist_mod.write_shards(str(tmp_path), [(n // 2, n, np.ones((n - n // 2, 3), np.float32))],
                          CFG, 1, fingerprint=stale_fp)
    dist_mod.write_shards(str(tmp_path), [(0, n // 2, means[:n // 2])], CFG, 0, fingerprint=fp)
    assert dist_mod.wait_for_shards(str(tmp_path), 2, timeout=0.5, fingerprint=fp) == [
        "shard_00000.npz"]
    img = dist_mod.assemble_shards(str(tmp_path), CFG, scene=scene, fingerprint=fp)
    assert torch.equal(img, ref)
    with pytest.raises(ValueError, match="missing"):
        dist_mod.assemble_shards(str(tmp_path), CFG, fingerprint=fp)


def test_lost_hosts_sentinel_roundtrip(tmp_path):
    assert dist_mod.wait_all_or_lost(str(tmp_path), 2, timeout=0.3) == "timeout"
    dist_mod.signal_lost_hosts(str(tmp_path))
    assert dist_mod.wait_all_or_lost(str(tmp_path), 2, timeout=0.3) == "lost"


def test_process_group_of_one_from_torch_env(monkeypatch):
    """init_distributed from MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK; the
    replicated and the shard render of a group of one equal one pass."""
    import torch.distributed as dist

    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(_free_port())),
                 ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(k, v)
    scene, means, ref = _means()
    dist_mod.init_distributed()
    try:
        mesh = dist_mod.global_mesh()
        assert mesh.shape == {"tiles": 1, "samples": 1}
        assert dist_mod.rank_device(torch.device("cpu")) == torch.device("cpu")
        assert torch.equal(dist_mod.render_image_multihost(scene, CFG, mesh), ref)
        [(start, stop, got)] = dist_mod.render_shard_multihost(scene, CFG, mesh)
        assert (start, stop) == (0, CFG.num_cells)
        np.testing.assert_array_equal(got, means)
        with pytest.raises(ValueError, match="not divisible"):
            dist_mod.global_mesh(n_samples=2)
    finally:
        dist.destroy_process_group()


def test_init_distributed_names_what_is_missing(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        dist_mod.init_distributed(num_processes=2, process_id=0)


def test_a_jax_rendered_shard_assembles_in_the_port(tmp_path):
    """The JAX CLI's own shard (its render of the left half) assembles in
    the port with the port's right half to the port's image within float32
    rounding of the two packages (scale-aware 1e-5 on 99.9% of cells)."""
    scene, means, _ = _means()
    n = CFG.num_cells
    js = pt.get_scene("box", CFG.width, CFG.height)
    jmeans = np.asarray(jax_render_cells_range(js, JCFG, jnp.arange(n // 2, dtype=jnp.int32), 0,
                                               JCFG.spp) / JCFG.spp, np.float32)
    fp = jax_dist.render_fingerprint(js, JCFG)
    jax_dist.write_shards(str(tmp_path), [(0, n // 2, jmeans)], JCFG, 0, fingerprint=fp)
    dist_mod.write_shards(str(tmp_path), [(n // 2, n, means[n // 2:])], CFG, 1,
                          fingerprint=dist_mod.render_fingerprint(scene, CFG))
    img = dist_mod.assemble_shards(str(tmp_path), CFG, fingerprint=fp).numpy()
    ref = finalize_image(torch.from_numpy(means), CFG).numpy()
    dev = scale_aware(img, ref)
    assert float(np.mean(dev > 1e-5)) <= 1e-3
