"""The port's Threefry RNG against the JAX package: bitwise.

Every random draw of both packages is a 13-round Threefry-2x32 of
(seed, cell, sample, purpose), so the port must reproduce the JAX words and
uniforms bit for bit; everything downstream is held to that.
"""

import numpy as np
import pytest
import torch

from cpu_path_tracing_tpu.ops import rng as jrng
from cpu_path_tracing_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

# Random123 kat_vectors, Threefry2x32 R=20 (as tests/test_rng.py).
KAT_R20 = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=(4, n), dtype=np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry_bitwise_vs_jax(rounds):
    k0, k1, c0, c1 = _words(4096, rounds)
    j0, j1 = jrng.threefry2x32(k0, k1, c0, c1, rounds=rounds)
    t0, t1 = trng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1), rounds=rounds)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


@pytest.mark.parametrize("key,ctr,expect", KAT_R20)
def test_threefry_20round_random123_kat(key, ctr, expect):
    y0, y1 = trng.threefry2x32(key[0], key[1], ctr[0], ctr[1], rounds=20)
    assert (int(y0), int(y1)) == expect


def test_item_keys_and_camera_uniforms_bitwise():
    cells = np.arange(5000, dtype=np.int32) * 37
    samples = np.full(5000, 3, np.int32)
    ja0, ja1 = jrng.item_keys(12345, cells, samples)
    ta0, ta1 = trng.item_keys(12345, _t(cells), _t(samples))
    np.testing.assert_array_equal(ta0.numpy(), np.asarray(ja0).astype(np.int64))
    np.testing.assert_array_equal(ta1.numpy(), np.asarray(ja1).astype(np.int64))
    ju = np.asarray(jrng.camera_uniforms(ja0, ja1))
    tu = trng.camera_uniforms(ta0, ta1)
    assert tu.dtype == torch.float32 and ju.dtype == np.float32
    np.testing.assert_array_equal(tu.numpy(), ju)


@pytest.mark.parametrize("per_ray_depth", [False, True])
def test_bounce_uniforms_bitwise(per_ray_depth):
    k0, k1, d, _ = _words(4096, 7)
    depth = (d % 100).astype(np.int32) if per_ray_depth else 41
    ju = np.asarray(jrng.bounce_uniforms(k0, k1, depth))
    tu = trng.bounce_uniforms(_t(k0), _t(k1), _t(depth) if per_ray_depth else depth)
    assert tu.shape == (4096, 4) and tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy(), ju)
