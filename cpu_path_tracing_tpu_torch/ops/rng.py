"""Counter-based RNG: Threefry-2x32, bit-identical to the JAX package.

Counterpart of ``cpu_path_tracing_tpu/ops/rng.py``.  Every draw is a pure
function of ``(seed, cell, sample, purpose)``:

    item key   (a0,a1) = threefry2x32((s0,s1), (cell, sample))
    draw block (y0,y1) = threefry2x32((a0,a1), (purpose, block))

Draw layout per (cell, sample): the item-key words are the subpixel jitter,
purpose 0 is the lens-disk pair, purpose ``1 + depth`` the bounce block
``[u_rr, u_a, u_b, u_c]`` (``u_c`` reserved).  13 rounds with Random123 key
injection after every 4th round only.

PyTorch has no uint32 arithmetic on the CPU, so words are carried in int64
tensors holding values in ``[0, 2**32)`` and every sum and shift is masked
back to 32 bits.  The CUDA kernel (``csrc/step_math.cuh``) computes the same
cipher in native uint32.  Uniforms are made in float32 from the top 24 bits,
whatever the scene dtype, so f32 and f64 renders consume the same draws.
"""

from __future__ import annotations

from typing import Tuple

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
ROUNDS = 13


def _word(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(int(x) & _MASK, dtype=torch.int64, device=device)


def int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor of the same bits, the
    storage the CUDA kernels take for a word."""
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32), words).to(torch.int32)


def words_from_int32(bits: torch.Tensor) -> torch.Tensor:
    """The inverse of ``int32_bits``: int32 bit patterns -> int64 words."""
    return bits.to(torch.int64) & _MASK


def threefry2x32(k0, k1, c0, c1, rounds: int = ROUNDS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 block: keys (k0,k1), counter (c0,c1) -> 2 words.

    Inputs are Python ints or int64 tensors of uint32 values and broadcast;
    the outputs are int64 tensors of uint32 values."""
    like = next((v for v in (c0, c1, k0, k1) if isinstance(v, torch.Tensor)), None)
    k0, k1, c0, c1 = (_word(v, like) for v in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + k0) & _MASK
    x1 = (c1 + k1) & _MASK
    done = 0
    group = 0
    while done < rounds:
        for r in _ROTATIONS[group % 2]:
            if done == rounds:
                break
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
            done += 1
        if done % 4 == 0:
            x0 = (x0 + ks[(group + 1) % 3]) & _MASK
            x1 = (x1 + ks[(group + 2) % 3] + (group + 1)) & _MASK
        group += 1
    return x0, x1


def master_key(seed: int) -> Tuple[int, int]:
    """Split a Python seed into the (s0, s1) cipher key."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def item_keys(seed, cell_ids, sample_idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(cell, sample) key pair (one cipher block)."""
    s0, s1 = master_key(seed) if isinstance(seed, int) else seed
    return threefry2x32(s0, s1, cell_ids, sample_idx)


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 uniform in [0,1) from the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def uniforms4(a0, a1, purpose) -> torch.Tensor:
    """[B,4] float32 uniforms for draw purpose ``purpose`` (two blocks)."""
    y0, y1 = threefry2x32(a0, a1, purpose, 0)
    y2, y3 = threefry2x32(a0, a1, purpose, 1)
    return torch.stack([_to_uniform(y) for y in (y0, y1, y2, y3)], dim=-1)


def camera_uniforms(a0, a1) -> torch.Tensor:
    """[B,4]: [jitter_x, jitter_y, disk_u1, disk_u2].  The jitter is the
    item-key words themselves; only the lens-disk pair costs a block."""
    y0, y1 = threefry2x32(a0, a1, 0, 0)
    return torch.stack([_to_uniform(a0), _to_uniform(a1), _to_uniform(y0), _to_uniform(y1)], dim=-1)


def bounce_uniforms(a0, a1, depth) -> torch.Tensor:
    """[B,4]: [u_rr, u_a, u_b, u_c] for bounce ``depth`` (int or [B])."""
    p = (_word(depth, a0) + 1) & _MASK
    return uniforms4(a0, a1, torch.broadcast_to(p, a0.shape))
