"""ctypes binding of the native I/O runtime (``native/src/ptio.cpp``).

The port's own copy of ``cpu_path_tracing_tpu/utils/native.py``: the same
library (``native/build/libptio.so``, built on demand with ``make -C
native`` when it is missing) and the same entry points: the gamma transfer,
the PPM and PNG writers, and a writer thread that encodes frames while the
caller goes on.  Each writer has a byte-identical NumPy version in
``utils/image.py``, which runs where the library is missing or cannot load.
That is host I/O; nothing here touches a device.

Set ``PT_TPU_NATIVE=0`` to use the NumPy writers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "build", "libptio.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("PT_TPU_NATIVE", "1") == "0":
        return None
    if not os.path.exists(_LIB_PATH):
        make_dir = os.path.join(_REPO_ROOT, "native")
        if not os.path.exists(os.path.join(make_dir, "Makefile")):
            return None
        try:
            subprocess.run(["make", "-C", make_dir], check=True, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.ptio_tonemap_u8.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_uint8)]
    lib.ptio_tonemap_u8.restype = None
    lib.ptio_write_ppm.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int32, ctypes.c_int32]
    lib.ptio_write_ppm.restype = ctypes.c_int
    lib.ptio_write_png.argtypes = list(lib.ptio_write_ppm.argtypes)
    lib.ptio_write_png.restype = ctypes.c_int
    lib.ptio_async_submit.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.ptio_async_submit.restype = None
    lib.ptio_async_wait.argtypes = []
    lib.ptio_async_wait.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_f32(image) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(image), dtype=np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def tonemap_u8(image) -> Optional[np.ndarray]:
    """The gamma transfer to uint8, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    img = _as_f32(image)
    out = np.empty(img.size, np.uint8)
    lib.ptio_tonemap_u8(_ptr(img), ctypes.c_int64(img.size),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.reshape(img.shape)


def write_ppm(path: str, image) -> bool:
    """Write a P3 PPM; False without the library or on a failed write."""
    lib = _load()
    if lib is None:
        return False
    img = _as_f32(image)
    h, w = img.shape[:2]
    return lib.ptio_write_ppm(path.encode(), _ptr(img), w, h) == 0


def write_png(path: str, image) -> bool:
    """Write an RGB8 PNG; False without the library or on a failed write."""
    lib = _load()
    if lib is None:
        return False
    img = _as_f32(image)
    h, w = img.shape[:2]
    return lib.ptio_write_png(path.encode(), _ptr(img), w, h) == 0


def async_submit(path: str, image, png: bool = True) -> bool:
    """Queue a frame on the writer thread (the library copies the buffer, so
    the caller may reuse it at once).  False without the library: the
    caller then writes synchronously."""
    lib = _load()
    if lib is None:
        return False
    img = _as_f32(image)
    h, w = img.shape[:2]
    lib.ptio_async_submit(path.encode(), _ptr(img), w, h, 1 if png else 0)
    return True


def async_wait() -> int:
    """Wait until every queued frame is on disk; returns the failure count."""
    lib = _load()
    if lib is None:
        return 0
    return int(lib.ptio_async_wait())
