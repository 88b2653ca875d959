"""The machine-constant probe kernels: wrappers and plain versions.

``op_chain`` replaces the TPU kernel of
``scripts/perf_probe.py::_bench_kernel`` (a ``pallas_call`` over
register-resident (64,128) blocks) and ``stream_scale`` that of
``scripts/perf_probe.py::pallas_stream`` (a blocked stream ``y = 2 x``
through on-chip memory), both with CUDA C++ kernels for Hopper in
``csrc/probe.cu``.  ``scripts/torch_perf_probe.py`` times them to get the
card's constants.

What bounds them on an H100: ``op_chain`` the ALU issue rate, by design
(one thread per element holds its ``n_arrays`` values in registers and
applies the op ``iters`` times, so ``n_arrays`` independent dependency
chains per thread hide the ALU latency, and the launch moves only
``(n_arrays + 1) * 4`` bytes per element); ``stream_scale`` device-memory
bytes, 4 read and 4 written per element, and how near the peak a pass
comes is decided by its address pattern: one ``float4`` a thread, one
contiguous 8 KB tile a block, as many blocks as tiles, loads and stores
with the streaming hint (a persistent grid, strided, tiled or fed by TMA
bulk copies, measured 5-9% slower).

The ops are the bodies of ``perf_probe.py:87-122`` under the names of
``OPS``; ``fma`` is the one addition, the fused instruction asked for by
name, because the package builds with ``-fmad=false`` and ``mul_add`` is
therefore a multiply and an add, as in the render kernels.  Words of the
uint32 ops travel as ``ops/rng.py`` carries them, int64 tensors of values
in ``[0, 2**32)``, or as the kernel stores them, int32 bit patterns
(``rng.int32_bits``); the result comes back in the kind that was given.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ... import _build
from .. import rng as rng_ops


class OpSpec(NamedTuple):
    """One op chain: its code in ``csrc/probe.cu``, whether it works on
    uint32 words, its constants (float32 a, b, c and the word k), the
    iterations ``scripts/perf_probe.py`` runs it for, and the applications
    per chain in one trip of the kernel's loop (``kUnroll`` there)."""

    code: int
    words: bool
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0
    k: int = 0
    iters: int = 1024
    unroll: int = 1


def _f32(v: float) -> float:
    return float(np.float32(v))


OPS = {
    "mul_add": OpSpec(0, False, a=_f32(1.0000001), b=_f32(1e-9), iters=2048, unroll=8),
    "fma": OpSpec(1, False, a=_f32(1.0000001), b=_f32(1e-9), iters=2048, unroll=8),
    "add": OpSpec(2, False, b=_f32(1e-9), iters=2048, unroll=8),
    "sin": OpSpec(3, False, iters=256),
    "sqrt": OpSpec(4, False, b=_f32(1e-9), iters=512),
    "rsqrt": OpSpec(5, False, b=_f32(1e-9), iters=512),
    "select": OpSpec(6, False, a=_f32(0.9999), b=_f32(1e-6), c=0.5, iters=1024),
    "u32_round": OpSpec(7, True, k=0x9E3779B9, iters=1024, unroll=8),
    "threefry": OpSpec(8, True, k=7, iters=64),
}
# The chains per element the kernel is compiled for.
N_ARRAYS = (2, 8)
_MASK = 0xFFFFFFFF


def _check_chain(xs: torch.Tensor, op: str, iters: int) -> OpSpec:
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}: one of {sorted(OPS)}")
    spec = OPS[op]
    if xs.dim() != 2 or xs.shape[0] not in N_ARRAYS or xs.shape[1] < 1:
        raise ValueError(f"xs must be [n_arrays, n] with n_arrays in {N_ARRAYS} and n >= 1, "
                         f"got {tuple(xs.shape)}")
    want = (torch.int32, torch.int64) if spec.words else (torch.float32,)
    if xs.dtype not in want:
        raise ValueError(f"op {op!r} takes {' or '.join(map(str, want))}, got {xs.dtype}")
    if int(iters) != iters or iters < 0:
        raise ValueError(f"iters must be a non-negative integer, got {iters!r}")
    return spec


def _apply(x: torch.Tensor, op: str, spec: OpSpec, i: int) -> torch.Tensor:
    """One application of the chain's body; uint32 ops on int64 words."""
    if op == "mul_add":
        return x * spec.a + spec.b
    if op == "fma":  # one rounding: exact in float64 but for a rare double rounding
        return (x.double() * spec.a + spec.b).float()
    if op == "add":
        return x + spec.b
    if op == "sin":
        return torch.sin(x)
    if op == "sqrt":
        return torch.sqrt(x + spec.b)
    if op == "rsqrt":
        return 1.0 / torch.sqrt(x + spec.b)
    if op == "select":
        return torch.where(x > spec.c, x * spec.a, x + spec.b)
    if op == "u32_round":
        y = (x + spec.k) & _MASK
        return (((y << 13) & _MASK) | (y >> 19)) ^ x
    y0, y1 = rng_ops.threefry2x32(x, x ^ spec.k, x, (x + i) & _MASK)
    return y0 ^ y1


def op_chain_reference(xs: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """Plain PyTorch version of ``op_chain``: the same arguments and result,
    the body applied ``iters`` times with torch ops and the rows summed in
    order (uint32 sums wrap)."""
    spec = _check_chain(xs, op, iters)
    x = rng_ops.words_from_int32(xs) if xs.dtype == torch.int32 else xs
    for i in range(int(iters)):
        x = _apply(x, op, spec, i)
    acc = x[0]
    for row in x[1:]:
        acc = acc + row
    if not spec.words:
        return acc
    acc = acc & _MASK
    return rng_ops.int32_bits(acc) if xs.dtype == torch.int32 else acc


def op_chain(xs: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """``out[j] = sum_a body^iters(xs[a, j])`` for the body named ``op``.

    Args:
      xs: [n_arrays, n], n_arrays in ``N_ARRAYS``; float32 for the float
        ops, int64 words or int32 bit patterns for ``u32_round`` and
        ``threefry``.
      op: a key of ``OPS``; iters: applications of the body.
    Returns [n] in the dtype of ``xs``.

    On a CUDA tensor this launches the kernel (contiguous input) or raises.
    On a CPU tensor it runs the plain version.  ``op_chain.launches`` counts
    the launches.
    """
    spec = _check_chain(xs, op, iters)
    if xs.device.type == "cpu":
        return op_chain_reference(xs, op, iters)
    if xs.device.type != "cuda":
        raise ValueError(f"op_chain runs on CUDA or the CPU, not {xs.device}")
    bits = rng_ops.int32_bits(xs) if xs.dtype == torch.int64 else xs
    if not bits.is_contiguous():
        raise ValueError("xs must be contiguous")
    lib = _build.load()
    n_arrays, n = bits.shape
    out = torch.empty(n, dtype=bits.dtype, device=bits.device)
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pt_probe_op_chain(spec.code, n_arrays, bits.data_ptr(), out.data_ptr(), n,
                                    int(iters), spec.a, spec.b, spec.c, spec.k, stream)
    if err != 0:
        raise RuntimeError(f"op_chain launch failed: {lib.pt_error_string(err).decode()} ({err})")
    op_chain.launches += 1
    return rng_ops.words_from_int32(out) if xs.dtype == torch.int64 else out


op_chain.launches = 0

STREAM_SCALE = 2.0


def _check_stream(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.numel() < 1:
        raise ValueError(f"x must be a non-empty float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")


def check_stream_launch(x: torch.Tensor, y: torch.Tensor) -> None:
    """What the stream kernel takes beyond ``_check_stream``: one dense run
    of float32 in and out, each starting on a 16-byte boundary (it moves
    ``float4``; only the last ``n % 4`` elements go one by one).  A view
    such as ``x[1:]`` raises ValueError, it is not copied."""
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel moves float4)")


def stream_scale_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``stream_scale``: ``2 * x``."""
    _check_stream(x)
    return x * STREAM_SCALE


def stream_scale(x: torch.Tensor) -> torch.Tensor:
    """``y = 2 * x`` in one pass over device memory; x is float32 of any
    shape, y a new tensor shaped as x.

    On a CUDA tensor this launches the kernel (contiguous, 16-byte aligned:
    ``check_stream_launch``) or raises.  On a CPU tensor it runs the plain
    version.  ``stream_scale.launches`` counts the launches.
    """
    _check_stream(x)
    if x.device.type == "cpu":
        return stream_scale_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"stream_scale runs on CUDA or the CPU, not {x.device}")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    check_stream_launch(x, y)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pt_probe_stream(x.data_ptr(), y.data_ptr(), x.numel(), STREAM_SCALE, stream)
    if err != 0:
        raise RuntimeError(f"stream_scale launch failed: "
                           f"{lib.pt_error_string(err).decode()} ({err})")
    stream_scale.launches += 1
    return y


stream_scale.launches = 0
