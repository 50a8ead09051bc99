"""The device busy time of ``spectrobot_tpu_torch.breakdown``: overlapping
device intervals count once, so the idle share it reports is never
negative."""

import pytest

from spectrobot_tpu_torch.breakdown import busy_us


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),                  # overlapping
    ([(5.0, 6.0), (0.0, 2.0), (5.5, 5.7)], 3.0),      # nested, unsorted
    ([(0.0, 1.0), (1.0, 2.0), (4.0, 4.0)], 2.0),      # touching, empty
])
def test_busy_time_counts_overlap_once(intervals, busy):
    assert busy_us(intervals) == busy
