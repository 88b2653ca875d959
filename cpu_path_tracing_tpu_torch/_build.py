"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` are compiled at first use by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc -c`` per source, all started together, and linked
into one shared library with a plain C interface, which is loaded with
``ctypes``.  The library lands in ``_build/`` beside this file,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once.  The build uses IEEE division, square root
and trigonometry (no ``--use_fast_math``), as ``csrc/step_math.cuh``
requires.  ``nvcc -Xptxas -v`` output (registers, spills) is kept in a
``.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: no contraction of a*b+c into fma, so the kernel rounds as the
# plain PyTorch version does, term for term (PERF.md: the fmad choice).
FLAGS = ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str | None:
    """nvcc on PATH, else under CUDA_HOME, else the toolkit's usual place."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(flags: tuple[str, ...] = FLAGS) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + tuple(flags)).encode())
    return BUILD_DIR / f"libpt_kernels_{h.hexdigest()[:16]}.so"


def build(flags: tuple[str, ...] = FLAGS) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources and flags
    exists.  Returns its path.  Raises RuntimeError naming the command when
    nvcc is missing or fails.  Other ``flags`` than the default are for
    measurement (``scripts/torch_chip_measure.py`` builds with fma)."""
    lib = library_path(flags)
    if lib.exists():
        return lib
    tag = f"{os.getpid()}.tmp"
    objs = [lib.with_name(f"{lib.stem}.{src.stem}.{tag}.o") for src in _sources()]
    tmp = lib.with_suffix(f".{tag}")
    compiles = [["nvcc", *ARCH_FLAGS, *flags, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)]
    link = ["nvcc", *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(f"nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                           f"cannot run: {' '.join(compiles[0])}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    try:
        procs = [subprocess.Popen([nvcc, *cmd[1:]], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for cmd in compiles]
        outs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, out in zip(compiles, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            log.append(out)
        proc = subprocess.run([nvcc, *link[1:]], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                               f"{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, lib)
    return lib


def sass(flags: tuple[str, ...] = FLAGS) -> str:
    """The built library's machine code as ``cuobjdump -sass`` prints it (the
    tool beside nvcc), for counting what a kernel's loop really issues
    (``utils/roofline.sass_loops``).  Raises RuntimeError when the tool is
    missing or fails."""
    nvcc = find_nvcc()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump") if nvcc else None
    if not tool or not os.path.isfile(tool):
        raise RuntimeError("cuobjdump not found beside nvcc")
    proc = subprocess.run([tool, "-sass", str(build(flags))], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}): {proc.stderr}")
    return proc.stdout


@functools.cache
def load(flags: tuple[str, ...] = FLAGS) -> ctypes.CDLL:
    """Build if needed, load once, and declare the C entry points."""
    lib = ctypes.CDLL(str(build(flags)))
    vp = ctypes.c_void_p
    lib.pt_persistent_render.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_longlong), vp]
    lib.pt_persistent_render.restype = ctypes.c_int
    lib.pt_megakernel_step.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                                       ctypes.c_int, vp]
    lib.pt_megakernel_step.restype = ctypes.c_int
    lib.pt_replay_grid.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.pt_replay_grid.restype = ctypes.c_int
    lib.pt_replay_persistent.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong,
                                         vp]
    lib.pt_replay_persistent.restype = ctypes.c_int
    lib.pt_geometry_grid.argtypes = lib.pt_replay_grid.argtypes
    lib.pt_geometry_grid.restype = ctypes.c_int
    lib.pt_geometry_replay.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_int,
                                       ctypes.c_longlong, vp]
    lib.pt_geometry_replay.restype = ctypes.c_int
    lib.pt_probe_op_chain.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_uint, vp]
    lib.pt_probe_op_chain.restype = ctypes.c_int
    lib.pt_probe_stream.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_float, vp]
    lib.pt_probe_stream.restype = ctypes.c_int
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    return lib
