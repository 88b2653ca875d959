"""Threefry-2x32 (13 rounds, key injection after every 4th round).

Every draw is a function of ``(seed, cell, sample, purpose)``:

    item key   (a0, a1) = threefry2x32((s0, s1), (cell, sample))
    draw block (y0, y1) = threefry2x32((a0, a1), (purpose, block))

The item-key words are the subpixel jitter, purpose 0 the lens-disk pair,
purpose ``1 + depth`` the bounce block ``[u_rr, u_a, u_b, u_c]``.  Words
live in int64 tensors holding values in ``[0, 2**32)``; uniforms are made
in float32 from the top 24 bits, whatever the render's dtype.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
ROUNDS = 13


def _word(x, like):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return torch.as_tensor(int(x) & MASK, dtype=torch.int64, device=like.device)


def threefry2x32(k0, k1, c0, c1):
    """One block: keys (k0, k1), counter (c0, c1) -> two int64 words."""
    like = next(v for v in (c0, c1, k0, k1) if isinstance(v, torch.Tensor))
    k0, k1, c0, c1 = (_word(v, like) for v in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    done = group = 0
    while done < ROUNDS:
        for r in _ROTATIONS[group % 2]:
            if done == ROUNDS:
                break
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
            done += 1
        if done % 4 == 0:
            x0 = (x0 + ks[(group + 1) % 3]) & MASK
            x1 = (x1 + ks[(group + 2) % 3] + (group + 1)) & MASK
        group += 1
    return x0, x1


def master_key(seed: int):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK, seed >> 32


def item_keys(seed: int, cells, samples):
    s0, s1 = master_key(seed)
    return threefry2x32(s0, s1, cells, samples)


def _uniform(bits):
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def camera_uniforms(a0, a1):
    """[B,4]: jitter x, jitter y (the key words), lens-disk pair."""
    y0, y1 = threefry2x32(a0, a1, 0, 0)
    return torch.stack([_uniform(a0), _uniform(a1), _uniform(y0), _uniform(y1)], dim=-1)


def bounce_uniforms(a0, a1, depth: int):
    """[B,4]: [u_rr, u_a, u_b, u_c] of bounce ``depth``."""
    p = torch.full_like(a0, (depth + 1) & MASK)
    y0, y1 = threefry2x32(a0, a1, p, 0)
    y2, y3 = threefry2x32(a0, a1, p, 1)
    return torch.stack([_uniform(y) for y in (y0, y1, y2, y3)], dim=-1)
