"""The window's statistics, the trace's arithmetic and the frozen count."""

import pytest

from harness import roofline
from harness.stats import derive, per_unit_ms, percentile
from harness.trace import Trace, gaps, union


def test_percentile_and_window_mean_on_known_inputs():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == pytest.approx(95.05)
    assert percentile([3.0], 95) == 3.0
    assert percentile([1.0, 2.0], 50) == 1.5
    assert per_unit_ms(2.0, 400) == pytest.approx(5.0)
    with pytest.raises(ValueError):
        per_unit_ms(1.0, 0)


def test_seeds_are_drawn_alike_and_apart():
    assert derive(2**31 + 7, 1, 5) == derive(2**31 + 7, 1, 5)
    assert derive(2**31 + 7, 1, 5) != derive(2**31 + 7, 1, 6)
    assert 0 <= derive(2**40, 3) < 2**63


def test_idle_share_takes_the_union_of_two_streams():
    # Stream a runs [0, 40) and [60, 70); stream b [30, 50) and [65, 90);
    # the window is [0, 100): busy [0, 50) and [60, 90), 80 ns.
    rows = [("k_a", 0, 40), ("k_a", 60, 70), ("k_b", 30, 50), ("k_b", 65, 90)]
    t = Trace(window=(0, 100), device=rows,
              host=[("step", 0, 100), ("sync", 48, 62), ("launch", 88, 100)])
    assert union([(s, e) for _, s, e in rows]) == [(0, 50), (60, 90)]
    assert t.busy_s() == pytest.approx(80e-9)
    assert t.rows() == 4
    assert gaps([(0, 50), (60, 90)], 0, 100) == [(50, 60), (90, 100)]
    assert t.idle_gaps() == [["sync", pytest.approx(10e-9)], ["launch", pytest.approx(10e-9)]]
    assert t.device_seconds(r"k_b") == pytest.approx(45e-9)
    assert t.device_ops()[0] == ["k_a", pytest.approx(50e-9)]


def test_idle_share_clips_rows_to_the_window():
    t = Trace(window=(10, 20), device=[("k", 0, 15), ("k", 18, 30)], host=[])
    assert t.busy_s() == pytest.approx(7e-9)


def test_frozen_count_reproduces_k2s_bound():
    """1.64e11 issues for disco's 310,201,516 segments and 25,165,824 items
    at 8 spheres: 4.90 ms at 33.5 T issues/s, bound by operations."""
    ops = roofline.render_ops(8, 310_201_516, 25_165_824)
    assert ops.issues() == pytest.approx(1.64e11, rel=5e-3)
    ms, side = roofline.bound_ms(roofline.render_bytes(8, 25_165_824), ops.issues())
    assert side == "operations" and ms == pytest.approx(4.90, abs=0.005)


def test_replay_and_geometry_counts_add_their_terms():
    base = roofline.render_ops(8, 1000, 100).issues()
    assert roofline.render_ops(8, 1000, 100, prefix_terms=10).issues() == base + 11 * 1000 + 900 + 80
    g = roofline.geometry_ops(8, 1000, 100, sweep_bounces=5, missed=2, tied_bounces=1).issues()
    assert g == base + 5 * (228 + 42 + 8) + 2 * (105 + 84 + 9) + (123 + 6)
