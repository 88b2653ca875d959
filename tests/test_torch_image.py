"""The port's image I/O (``utils/image.py``) and its binding of the native
writers (``utils/native.py``), case for case with ``tests/test_image.py``
and ``tests/test_native.py``, and against the JAX package's writers.

Byte-for-byte parity: the gamma transfer (round-half-even), the PPM text
and the PNG stream (zlib level 6, filter 0) of the NumPy writers, of the
native library through the port's binding, and of the JAX package's
writers are the same bytes.  The native cases need ``native/build/
libptio.so`` (built by ``make -C native`` when missing) and skip without
it.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from cpu_path_tracing_tpu.utils import image as jax_image
from cpu_path_tracing_tpu_torch.utils import image as im
from cpu_path_tracing_tpu_torch.utils import native
from cpu_path_tracing_tpu_torch.utils.image import (
    color_to_int,
    flush_async_writes,
    read_ppm,
    tonemap,
    write_png,
    write_png_async,
    write_ppm,
)


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("native/build/libptio.so is not available")


def _img(seed=0, shape=(13, 17, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32) * 1.4 - 0.2


def _png_pixels(data: bytes, h: int, w: int) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert data[12:16] == b"IHDR"
    assert struct.unpack(">II", data[16:24]) == (w, h)
    i = data.index(b"IDAT")
    ln = struct.unpack(">I", data[i - 4:i])[0]
    rows = np.frombuffer(zlib.decompress(data[i + 4:i + 4 + ln]), np.uint8).reshape(h, 1 + w * 3)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_color_to_int_reference_values():
    # round(clamp(x)^(1/2.2)*255)
    assert color_to_int(np.array(0.0)) == 0
    assert color_to_int(np.array(1.0)) == 255
    assert color_to_int(np.array(2.0)) == 255  # clamps first
    assert color_to_int(np.array(-1.0)) == 0
    x = 0.5
    assert color_to_int(np.array(x)) == int(round((x ** (1 / 2.2)) * 255.0))
    v = np.random.default_rng(4).random(1000) * 1.4 - 0.2
    np.testing.assert_array_equal(color_to_int(torch.from_numpy(v)), jax_image.color_to_int(v))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ppm_roundtrip(tmp_path, dtype):
    img = np.random.default_rng(0).random((6, 8, 3)).astype(dtype)
    p, q = tmp_path / "t.ppm", tmp_path / "jax.ppm"
    write_ppm(str(p), torch.from_numpy(img))
    np.testing.assert_array_equal(read_ppm(str(p)), tonemap(img))
    assert p.read_text().split("\n")[:3] == ["P3", "8 6", "255"]
    jax_image.write_ppm(str(q), img)
    assert p.read_bytes() == q.read_bytes()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_png_is_decodable(tmp_path, dtype):
    img = np.random.default_rng(1).random((5, 7, 3)).astype(dtype)
    p, q = tmp_path / "t.png", tmp_path / "jax.png"
    write_png(str(p), torch.from_numpy(img))
    np.testing.assert_array_equal(_png_pixels(p.read_bytes(), 5, 7), tonemap(img))
    jax_image.write_png(str(q), img)
    assert p.read_bytes() == q.read_bytes()


def test_tonemap_bytes_equal(lib):
    img = _img()
    np.testing.assert_array_equal(native.tonemap_u8(img), tonemap(img))


def test_ppm_bytes_equal(lib, tmp_path):
    img = _img(1)
    a, b = str(tmp_path / "n.ppm"), str(tmp_path / "p.ppm")
    assert native.write_ppm(a, img)
    im.write_ppm(b, img.astype(np.float64))  # float64 takes the NumPy writer
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(read_ppm(a), tonemap(img))


def test_png_decodes_identically(lib, tmp_path):
    img = _img(2)
    p, q = str(tmp_path / "n.png"), str(tmp_path / "p.png")
    assert native.write_png(p, img)
    np.testing.assert_array_equal(_png_pixels(open(p, "rb").read(), 13, 17), tonemap(img))
    im.write_png(q, img.astype(np.float64))
    assert open(p, "rb").read() == open(q, "rb").read()


def test_gamma_boundary_values(lib):
    img = np.array([[[0.0, 1.0, 2.0]], [[-1.0, 0.5, 0.2176]]], np.float32)
    np.testing.assert_array_equal(native.tonemap_u8(img), tonemap(img))


def test_async_writer_matches_sync(tmp_path):
    """Async writes give the synchronous writer's bytes, with or without the
    native library (without it the frame is written at once)."""
    img = np.random.default_rng(3).random((20, 30, 3), dtype=np.float32)
    sync_path, async_path = str(tmp_path / "sync.png"), str(tmp_path / "async.png")
    write_png(sync_path, img)
    write_png_async(async_path, torch.from_numpy(img))
    flush_async_writes()
    assert open(async_path, "rb").read() == open(sync_path, "rb").read()


def test_async_writer_many_frames(tmp_path):
    img = np.zeros((8, 8, 3), np.float32)
    paths = [str(tmp_path / f"f{i}.png") for i in range(16)]
    for i, p in enumerate(paths):
        write_png_async(p, img + i / 16.0)
    flush_async_writes()
    sizes = {os.path.getsize(p) for p in paths}
    assert all(os.path.exists(p) for p in paths) and min(sizes) > 0
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(_png_pixels(open(p, "rb").read(), 8, 8),
                                      tonemap(img + i / 16.0))


def test_progressive_preview(tmp_path):
    """render_progressive writes partial previews at each batch but the last."""
    import cpu_path_tracing_tpu_torch as tp
    from cpu_path_tracing_tpu_torch.utils.checkpoint import render_progressive

    cfg = tp.RenderConfig(width=8, height=6, spp=4, max_depth=6)
    scene = tp.get_scene("box", 8, 6)
    preview = str(tmp_path / "preview.png")
    img = render_progressive(scene, cfg, flush_every=2, preview_path=preview)
    assert os.path.exists(preview)  # written at spp_done=2
    assert img.shape == (6, 8, 3)
    partial = render_progressive(scene, cfg.replace(spp=2), flush_every=2)
    assert open(preview, "rb").read() == _png_bytes(tmp_path, partial)


def _png_bytes(tmp_path, img) -> bytes:
    p = str(tmp_path / "ref.png")
    write_png(p, img.numpy().astype(np.float32))
    return open(p, "rb").read()
