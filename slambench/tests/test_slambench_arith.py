"""The metric arithmetic on made-up records, and the roofline byte counts."""

import math

import numpy as np
import pytest

from slambench import roofline, stats


def test_rate_is_whole_window():
    assert stats.rate(250, 50.0) == 5.0
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


def test_percentile_is_over_every_request():
    lat = list(range(1, 201))  # 200 requests, 1..200 ms
    assert stats.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert stats.percentile(lat, 95) == pytest.approx(190.05)
    # a tail made of a few slow requests shows, chunk medians would hide it
    lat = [10.0] * 190 + [500.0] * 10
    assert stats.percentile(lat, 95) > 10.0
    assert math.isnan(stats.percentile([], 95))


def test_gaps_between_completions():
    assert stats.gaps([3.0, 1.0, 2.5]) == pytest.approx([1.5, 0.5])


@pytest.mark.parametrize("intervals, covered", [
    ([], 0.0),
    ([(0.0, 1.0)], 1.0),
    ([(0.0, 1.0), (0.5, 2.0)], 2.0),  # two streams overlapping count once
    ([(0.0, 1.0), (3.0, 4.0)], 2.0),
    ([(0.0, 5.0), (1.0, 2.0), (6.0, 7.0)], 6.0),  # nested
])
def test_union_of_busy_intervals(intervals, covered):
    assert stats.union_seconds(intervals) == pytest.approx(covered)


def test_idle_share_from_union_not_sum():
    # two streams busy over the same second of a 4 s window: idle 0.75, where
    # 1 - summed busy / window would read 0.5
    busy = stats.union_seconds([(0.0, 1.0), (0.0, 1.0)])
    assert 1.0 - busy / 4.0 == pytest.approx(0.75)


def test_joint_entropy_bytes_from_shapes():
    # 27 renders and 3 warps of 960x540 one-byte bins read once, 81 scores written
    assert roofline.joint_entropy_bytes(27, 3, 960 * 540) == 30 * 518400 + 4 * 81


def test_render_gray_bytes_from_shapes():
    # the 190-grid terrain: 36,100 vertices, 71,442 faces, a 512x512 texture
    b = roofline.render_gray_bytes(36100, 71442, 512, 512, 27, 540, 960)
    assert b == 4 * (5 * 36100 + 3 * 71442 + 512 * 512 + 27 * 540 * 960)


def test_roofline_share():
    # 3.35 GB in 1 ms at 3.35 TB/s is the peak
    assert roofline.roofline_share(3.35e9, 1.0) == pytest.approx(100.0 * 1e-3)
    assert roofline.roofline_share(3.35e9, 1e-3) == pytest.approx(100.0)
    assert roofline.roofline_share(1.0, 0.0) is None
