"""The ``bias_fold_share`` reader on synthetic contexts: the change of
the program's three bias counters over the traced units' runs."""

from h100_bench.harness import manifest
from h100_bench.harness.runner import Context


def _ctx(before, after):
    return Context(memory_before=before, memory_after=after)


def test_bias_fold_share_reads_the_counters_change():
    read = manifest.reader("bias_fold_share")
    before = {"bias_folded": 100, "bias_alone": 50, "bias_op_by_op": 0}
    assert read(_ctx(before, {"bias_folded": 189, "bias_alone": 143,
                              "bias_op_by_op": 0})) == 100.0 * 89 / 182
    assert read(_ctx(before, {"bias_folded": 100, "bias_alone": 50,
                              "bias_op_by_op": 4})) == 0.0


def test_bias_fold_share_reads_nothing_without_the_counters():
    read = manifest.reader("bias_fold_share")
    same = {"bias_folded": 3, "bias_alone": 1, "bias_op_by_op": 0}
    assert read(_ctx(same, same)) is None
    assert read(_ctx({"epilogue_fused": 0}, {"epilogue_fused": 2})) is None
