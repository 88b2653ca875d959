"""Image output: gamma transfer, PPM and PNG writers (NumPy only).

Counterpart of ``cpu_path_tracing_tpu/utils/image.py`` without its native
fast path: ``color_to_int`` = ``round(clamp(x)^(1/2.2) * 255)``
(``src/utils.cpp:11-16``), the reference's P3 PPM (``src/main.cpp:240-247``)
and a zlib-only PNG writer with the same bytes as the JAX package's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


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
    h, w = img.shape[:2]
    ints = color_to_int(img).reshape(-1)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write(" ".join(str(v) for v in ints))
        f.write(" ")


def write_png(path: str, image) -> None:
    """Minimal RGB8 PNG (zlib level 6, filter 0 on every row)."""
    img = tonemap(image)
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
