"""Image output: gamma transfer, PPM and PNG writers.

Counterpart of ``cpu_path_tracing_tpu/utils/image.py``: ``color_to_int`` =
``round(clamp(x)^(1/2.2) * 255)`` (``src/utils.cpp:11-16``), the
reference's P3 PPM (``src/main.cpp:240-247``) and a zlib-only PNG writer.
A float32 image goes through the native writers of ``utils/native.py``
when the library loads; the NumPy writers here write the same bytes and
run otherwise.  ``write_png_async`` hands a frame to the native writer
thread (a synchronous write without it), ``flush_async_writes`` waits for
the queued frames, and ``read_ppm`` reads a P3 PPM back.  Images may be
torch tensors on any device or NumPy arrays.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native as _native


def _array(image) -> np.ndarray:
    if hasattr(image, "detach"):  # a torch tensor, on any device
        image = image.detach().cpu().numpy()
    return np.asarray(image)


def color_to_int(x) -> np.ndarray:
    """Gamma-2.2 transfer, vectorized ``pt::color_to_int``."""
    corrected = np.clip(np.asarray(_array(x), np.float64), 0.0, 1.0) ** (1.0 / 2.2)
    return np.rint(corrected * 255.0).astype(np.int32)


def tonemap(image) -> np.ndarray:
    """Linear [H,W,3] -> uint8 [H,W,3] via the reference transfer."""
    return color_to_int(image).astype(np.uint8)


def write_ppm(path: str, image) -> None:
    """P3 PPM, byte-compatible with ``src/main.cpp:240-247``."""
    img = _array(image)
    if img.dtype == np.float32 and _native.write_ppm(path, img):
        return
    h, w = img.shape[:2]
    ints = color_to_int(img).reshape(-1)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write(" ".join(str(v) for v in ints))
        f.write(" ")


def write_png(path: str, image) -> None:
    """Minimal RGB8 PNG (zlib level 6, filter 0 on every row)."""
    img = _array(image)
    if img.dtype == np.float32 and _native.write_png(path, img):
        return
    img = tonemap(img)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def write_png_async(path: str, image) -> None:
    """Queue the frame on the native writer thread, so that encoding and
    the write overlap the caller's next work; without the library, write
    it now."""
    img = _array(image)
    if not (img.dtype == np.float32 and _native.async_submit(path, img, png=True)):
        write_png(path, img)


def flush_async_writes() -> None:
    """Wait for every queued frame to reach disk; raises on writer errors."""
    errs = _native.async_wait()
    if errs:
        raise IOError(f"{errs} async image write(s) failed")


def read_ppm(path: str) -> np.ndarray:
    """Read a P3 PPM back into uint8 [H,W,3]."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "P3" or int(tokens[3]) != 255:
        raise ValueError(f"{path}: not a P3 PPM with maxval 255")
    w, h = int(tokens[1]), int(tokens[2])
    vals = np.array(tokens[4:4 + w * h * 3], dtype=np.int32)
    return vals.reshape(h, w, 3).astype(np.uint8)
