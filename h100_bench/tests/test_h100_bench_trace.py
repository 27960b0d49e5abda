"""The traced window's reduction: busy time as the union of device
intervals, idle gaps labelled by the innermost host operator."""

from __future__ import annotations

import pytest

from h100_bench.harness.trace import Trace


def test_busy_is_the_union_and_gaps_take_the_innermost_host_op():
    device = [(0.0, 1.0, "k_a"), (0.5, 2.0, "k_b"), (3.0, 4.0, "k_a")]
    host = [(0.0, 10.0, "outer"), (2.2, 2.8, "inner"), (4.0, 5.0, "late")]
    t = Trace(device, host, 0.0, 5e6)
    assert t.window_s == pytest.approx(5.0)
    assert t.busy_s == pytest.approx(3.0)
    b = t.breakdown()
    assert b["device_ops"] == [["k_a", 2.0], ["k_b", 1.5]]
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    assert gaps["inner"] == pytest.approx(1.0)       # the gap 2.0-3.0
    assert gaps["late"] == pytest.approx(1.0)        # the gap 4.0-5.0
