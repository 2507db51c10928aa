"""The percentile, rate, interval and gap arithmetic on made-up data."""

import math

import pytest

from bench.harness import stats, trace


@pytest.mark.parametrize(
    "values, q, want",
    [
        (list(range(1, 101)), 90, 90),
        (list(range(1, 101)), 95, 95),
        (list(range(100, 0, -1)), 90, 90),
        ([5.0], 90, 5.0),
        ([3.0, 1.0, 2.0], 50, 2.0),
        (list(range(1, 114)), 90, 102),  # ceil(0.9 * 113) = 102
    ],
)
def test_percentile_nearest_rank(values, q, want):
    assert stats.percentile(values, q) == want


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(516_018 * 113, 30.25) == pytest.approx(516_018 * 113 / 30.25)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize(
    "intervals, want",
    [
        ([], []),
        ([(0, 1), (2, 3)], [(0, 1), (2, 3)]),
        ([(0, 2), (1, 3)], [(0, 3)]),
        ([(1, 3), (0, 2), (5, 6), (2.5, 2.7)], [(0, 3), (5, 6)]),
        ([(0, 10), (1, 2), (3, 4)], [(0, 10)]),
        ([(0, 1), (1, 2)], [(0, 2)]),
        ([(2, 2), (3, 1)], []),
    ],
)
def test_union_merges_overlaps(intervals, want):
    assert stats.union(intervals) == want


def test_union_and_gaps_partition_the_window():
    merged = stats.union([(1, 2), (1.5, 3), (4, 5), (9, 12)])
    idle = stats.gaps(merged, 0, 10)
    assert idle == [(0, 1), (3, 4), (5, 9)]
    busy = sum(min(e, 10) - s for s, e in merged)
    assert busy == pytest.approx(2 + 1 + 1)
    assert busy + sum(b - a for a, b in idle) == pytest.approx(10)


def test_summary_busy_idle_and_labels():
    ev = trace.Event
    events = [
        ev(trace.WINDOW, False, 0.0, 10.0),
        ev("session.call", False, 0.7, 4.5),
        ev("engine.alpha", False, 1.0, 3.0),
        ev("session.call", False, 5.0, 9.5),
        ev("kernelA", True, 1.0, 2.0),
        ev("kernelA", True, 1.5, 2.5),  # overlaps: counted once
        ev("Memcpy DtoH (Device -> Pageable)", True, 6.0, 8.0),
        ev("engine.alpha", True, 1.0, 3.0),  # a range's device-side copy: no operation
        ev("kernelB", True, 11.0, 12.0),  # outside the window
    ]
    s = trace.summarize(events, ["session.call", "engine.alpha", trace.WINDOW])
    assert s.window_s == 10.0
    assert s.busy_s == pytest.approx(1.5 + 2.0)
    assert [e.name for e in s.kernels()] == ["kernelA", "kernelA"]
    assert s.time_of("DtoH") == pytest.approx(2.0)
    idle = dict(s.idle_by_label)
    # gaps [0, 1), [2.5, 6), [8, 10), each named by the range open at its middle
    assert math.fsum(idle.values()) == pytest.approx(10 - 3.5)
    assert idle[trace.WINDOW] == pytest.approx(1.0)
    assert idle["session.call"] == pytest.approx(3.5 + 2.0)


def test_summary_needs_one_window():
    with pytest.raises(ValueError):
        trace.summarize([trace.Event("x", True, 0, 1)], [])
