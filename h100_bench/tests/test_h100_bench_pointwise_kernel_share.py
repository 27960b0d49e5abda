"""The ``pointwise_kernel_share`` reader on synthetic contexts: the change
of the program's two 1x1 convolution counters over the traced units'
runs."""

from h100_bench.harness import manifest
from h100_bench.harness.runner import Context


def _ctx(before, after):
    return Context(memory_before=before, memory_after=after)


def test_pointwise_kernel_share_reads_the_counters_change():
    read = manifest.reader("pointwise_kernel_share")
    before = {"pointwise_kernel": 64, "pointwise_library": 180}
    assert read(_ctx(before, {"pointwise_kernel": 96,
                              "pointwise_library": 270})) == 100.0 * 32 / 122
    assert read(_ctx(before, {"pointwise_kernel": 64,
                              "pointwise_library": 270})) == 0.0


def test_pointwise_kernel_share_reads_nothing_without_the_counters():
    read = manifest.reader("pointwise_kernel_share")
    same = {"pointwise_kernel": 3, "pointwise_library": 1}
    assert read(_ctx(same, same)) is None
    assert read(_ctx({"bias_folded": 0}, {"bias_folded": 2})) is None
