"""The frozen yardstick of the kernels' rooflines.

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
published memory rate, and the operations these inputs need over the
card's published rate of float32 issues (``bound_ms``).  The operations
are counted per path segment, per continuing segment, per item and, for
the replay, per non-zero term of its accumulation, from the expression
chains of the path estimator; the counts they are multiplied by come from
the benchmark's own reference over the same inputs (``plainref.paths``),
never from a kernel's statistics.

Counting rule: every float or integer add, subtract, multiply, compare,
select, conversion, shift and xor is one ``simple`` operation; a square
root, a division and a sine or cosine one operation of their own class; a
13-round Threefry-2x32 block 42 simple operations.  The bound charges
every operation one issue, which is a floor.  Every sphere is tested on
every segment: a kernel that culls spheres (a BVH) would read above 100%
and needs a recount first.

Copied from the port's ``utils/roofline.py`` as it stood when the
benchmark was made; K7's record traffic is left out of its bytes, since
it belongs to that kernel's design and not to its function.
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA's data sheet for the H100 SXM at its 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_ISSUES_PER_S = 33.5e12  # 132 SMs x 128 lanes x 1.98 GHz
POWER_LIMIT_W = 700
THREEFRY_BLOCK_OPS = 42
FLOAT32 = 4


class OpCounts(NamedTuple):
    simple: int = 0
    threefry: int = 0
    sqrt: int = 0
    div: int = 0
    sincos: int = 0

    def issues(self) -> int:
        return (self.simple + THREEFRY_BLOCK_OPS * self.threefry + self.sqrt + self.div
                + self.sincos)

    def plus(self, other: "OpCounts") -> "OpCounts":
        return OpCounts(*(a + b for a, b in zip(self, other)))

    def times(self, n: int) -> "OpCounts":
        return OpCounts(*(n * a for a in self))


def segment_ops(n_spheres: int) -> OpCounts:
    """Every path segment: one Threefry block and two uniforms (1 + 6), the
    ray's squared length and its reciprocal (5, one division), and per
    sphere the anchor-point quadratic and its root choice (48, one square
    root, one division)."""
    return OpCounts(simple=12 + 48 * n_spheres, threefry=1, sqrt=n_spheres, div=n_spheres + 1)


def continue_ops() -> OpCounts:
    """A segment that goes on, at the least: the hit record, the emission
    pickup, the roulette test, the cheapest sampler (mirror) and the state
    update."""
    return OpCounts(simple=64, sqrt=1, div=1)


def item_ops() -> OpCounts:
    """Once an item: its cell, sample, pixel and subpixel (4 divisions, 11),
    the item key and lens pair (two blocks, 12), four conversions, the
    screen position (10) and the thin-lens ray (41, a square root, a sine
    and a cosine)."""
    return OpCounts(simple=78, threefry=2, sqrt=1, div=4, sincos=2)


def render_ops(n_spheres: int, segments: int, n_items: int, prefix_terms: int | None = None):
    """A render of ``n_items`` paths with ``segments`` segments in all; with
    ``prefix_terms`` the replay's accumulation too: 11 more a segment, 1 a
    continuing segment and 8 a non-zero prefix term."""
    seg, cont = segment_ops(n_spheres), continue_ops()
    extra = OpCounts()
    if prefix_terms is not None:
        seg, cont = seg.plus(OpCounts(simple=11)), cont.plus(OpCounts(simple=1))
        extra = OpCounts(simple=8).times(prefix_terms)
    return (seg.times(segments).plus(cont.times(segments - n_items))
            .plus(item_ops().times(n_items)).plus(extra))


def geometry_ops(n_spheres: int, segments: int, n_items: int, sweep_bounces: int, missed: int,
                 tied_bounces: int = 0) -> OpCounts:
    """The geometry replay: the forward render's operations, a bounce swept
    back (228, a block, 2 square roots, 6 divisions), a path that ended on
    a miss (105, two blocks, 2 square roots, 5 divisions, a sine and a
    cosine) and a swept bounce whose root tied (123, a square root, 5
    divisions)."""
    return (render_ops(n_spheres, segments, n_items)
            .plus(OpCounts(simple=228, threefry=1, sqrt=2, div=6).times(sweep_bounces))
            .plus(OpCounts(simple=105, threefry=2, sqrt=2, div=5, sincos=2).times(missed))
            .plus(OpCounts(simple=123, sqrt=1, div=5).times(tied_bounces)))


def scene_bytes(n_spheres: int) -> int:
    """The sphere table (17 floats a sphere) and the camera (20 floats)."""
    return FLOAT32 * (17 * n_spheres + 20)


def render_bytes(n_spheres: int, n_items: int) -> int:
    """K2: the scene in, each item's radiance out."""
    return scene_bytes(n_spheres) + FLOAT32 * 3 * n_items


def replay_bytes(n_spheres: int, n_cells: int) -> int:
    """K3: the scene and each cell's cotangent in, 7N+6 partials out."""
    return scene_bytes(n_spheres) + FLOAT32 * (3 * n_cells + 7 * n_spheres + 6)


def geometry_bytes(n_spheres: int, n_cells: int) -> int:
    """K7: the scene and each cell's cotangent in, 4N+14 partials out."""
    return scene_bytes(n_spheres) + FLOAT32 * (3 * n_cells + 4 * n_spheres + 14)


def bound_ms(nbytes: int, issues: int):
    """(the least time in ms, 'bytes' or 'operations')."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = issues / PEAK_FP32_ISSUES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
