"""The ``depthwise_kernel_share`` reader on synthetic contexts: the change
of the program's two depthwise convolution counters over the traced
units' runs."""

from h100_bench.harness import manifest
from h100_bench.harness.runner import Context


def _ctx(before, after):
    return Context(memory_before=before, memory_after=after)


def test_depthwise_kernel_share_reads_the_counters_change():
    read = manifest.reader("depthwise_kernel_share")
    before = {"depthwise_kernel": 85, "depthwise_library": 0}
    assert read(_ctx(before, {"depthwise_kernel": 170,
                              "depthwise_library": 0})) == 100.0
    assert read(_ctx(before, {"depthwise_kernel": 110,
                              "depthwise_library": 75})) == 25.0
    assert read(_ctx(before, {"depthwise_kernel": 85,
                              "depthwise_library": 17})) == 0.0


def test_depthwise_kernel_share_reads_nothing_without_the_counters():
    read = manifest.reader("depthwise_kernel_share")
    same = {"depthwise_kernel": 3, "depthwise_library": 1}
    assert read(_ctx(same, same)) is None
    assert read(_ctx({"pointwise_kernel": 0},
                     {"pointwise_kernel": 2})) is None
