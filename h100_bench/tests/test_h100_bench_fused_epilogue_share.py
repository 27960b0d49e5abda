"""The ``fused_epilogue_share`` reader on synthetic contexts: the change
of the program's two counters over the traced units' runs."""

from h100_bench.harness import manifest
from h100_bench.harness.runner import Context


def _ctx(before, after):
    return Context(memory_before=before, memory_after=after)


def test_fused_epilogue_share_reads_the_counters_change():
    read = manifest.reader("fused_epilogue_share")
    before = {"epilogue_fused": 400, "epilogue_op_by_op": 7}
    assert read(_ctx(before, {"epilogue_fused": 1000,
                              "epilogue_op_by_op": 7})) == 100.0
    assert read(_ctx(before, {"epilogue_fused": 430,
                              "epilogue_op_by_op": 17})) == 75.0
    assert read(_ctx(before, {"epilogue_fused": 400,
                              "epilogue_op_by_op": 27})) == 0.0


def test_fused_epilogue_share_reads_nothing_without_the_counters():
    read = manifest.reader("fused_epilogue_share")
    same = {"epilogue_fused": 3, "epilogue_op_by_op": 1}
    assert read(_ctx(same, same)) is None
    assert read(_ctx({"eager_calls": 0}, {"eager_calls": 2})) is None
