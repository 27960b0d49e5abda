"""The ``full_arcface`` configuration: iresnet50's size and its frozen
counts against the benchmark's graph, the readers of its per-layer
metrics on synthetic contexts, and the whole harness on the CPU at a
tiny size (one block a stage, narrow widths)."""

from __future__ import annotations

import copy
import json
import os

import pytest
import torch

from bench_tiny import ROOT, run_tiny, tiny_cell
from h100_bench.counts import flops, k5_affine_bytes
from h100_bench.harness import manifest, netspec
from h100_bench.harness.runner import Context
from h100_bench.networks import iresnet

CELL = "full_arcface.stream16"


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "h100_bench", "configs",
                           "full_arcface.json")) as f:
        return json.load(f)["networks"]["embedding"]


@pytest.fixture(scope="module")
def graph(spec):
    return iresnet.build(netspec.Draws(0, torch.device("cpu")), spec)


def test_iresnet50_has_insightfaces_size(spec, graph):
    """43,590,848 parameters (InsightFace's 43.6 M for r50) and
    6,309,330,944 multiply-adds a 112 px face (its 6.3 G), the latter
    frozen in ``macs/iresnet50.json`` and counted over the graph."""
    assert iresnet.parameters(spec) == spec["weights"] == 43_590_848
    assert flops.network_macs("iresnet50") == flops.graph_macs(graph) == \
        6_309_330_944
    assert graph.tensors[graph.outputs[0]].shape == (1, 512)


def test_affine_bytes_are_the_graphs_sites(graph):
    """25 sites (the stem's PReLU and the 24 blocks' ends), all but the
    last kept for an identity or a downsample; the frozen count equals a
    count over the graph."""
    sites = k5_affine_bytes.sites(graph)
    assert len(sites) == 25
    assert [s["keep"] for s in sites] == [True] * 24 + [False]
    assert [len(s["inputs"]) for s in sites] == [1] + [2] * 24
    assert k5_affine_bytes.network_bytes("iresnet50") == \
        k5_affine_bytes.graph_bytes(graph)
    assert k5_affine_bytes.network_bytes("mobilefacenet_192") is None


def _units(faces):
    return [([0, 1], faces)]


def test_embedding_mfu_reads_the_stamped_group():
    read = manifest.reader("embedding_mfu")
    cfg = {"networks": {"embedding": {"name": "iresnet50"}}}
    ctx = Context(timings={"device.embedding": (10.0, 2)}, config=cfg,
                  traced_units=_units([12, 13]))
    peak = flops.load(flops.PEAKS)["fp32_flops_per_s"]
    assert read(ctx) == pytest.approx(
        100.0 * 2 * 6_309_330_944 * 25 / (10e-3 * peak))
    assert read(Context(timings={}, config=cfg,
                        traced_units=_units([1]))) is None
    assert read(Context(timings={"device.embedding": (1.0, 1)},
                        config={"networks": {"embedding": None}},
                        traced_units=_units([1]))) is None


def test_affine_fold_share_reads_the_counters_change():
    read = manifest.reader("affine_fold_share")
    before = {"affine_folded": 10, "affine_op_by_op": 0}
    assert read(Context(memory_before=before, memory_after={
        "affine_folded": 60, "affine_op_by_op": 0})) == 100.0
    assert read(Context(memory_before=before, memory_after={
        "affine_folded": 10, "affine_op_by_op": 5})) == 0.0
    assert read(Context(memory_before=before, memory_after=before)) is None
    assert read(Context(memory_before={"bias_folded": 0},
                        memory_after={"bias_folded": 4})) is None


class _Trace:
    def __init__(self, ops):
        self.ops = ops

    def time_by(self, match):
        return sum(s for n, s in self.ops if match(n))


def test_k5_affine_roofline_reads_the_affine_instance():
    read = manifest.reader("k5_affine_roofline")
    cfg = {"networks": {"embedding": {"name": "iresnet50"}}}
    trace = _Trace([("void (anonymous namespace)::residual_act_affine_kernel"
                     "<float4, 0, 1, true>(...)", 0.002),
                    ("void (anonymous namespace)::residual_act_kernel"
                     "<float4, 2, 0, true>(...)", 0.5)])
    bw = flops.load(flops.PEAKS)["hbm_bytes_per_s"]
    got = read(Context(trace=trace, config=cfg, traced_units=_units([3])))
    assert got == pytest.approx(100.0 * 38_033_408 * 3 / bw / 0.002)
    assert read(Context(trace=_Trace([]), config=cfg,
                        traced_units=_units([3]))) is None
    assert read(Context(trace=trace, config={"networks": {
        "embedding": {"name": "mobilefacenet_192"}}},
        traced_units=_units([3]))) is None


def test_the_cell_is_correct_on_the_cpu():
    """The tiny cell (one block a stage at widths 8 to 32) through the
    whole harness: the port's FULL program with the iResNet graph against
    ``reference/pipeline_arcface.py``, embeddings compared."""
    cell = copy.deepcopy(tiny_cell(CELL))
    cell["config"]["networks"]["embedding"].update(
        layers=[1, 1, 1, 1], widths=[8, 16, 16, 32])
    result, err = run_tiny(cell)
    assert result["correct"], err
    counts = result["sample"]["faces"]
    assert counts["compared"] > 0 and counts["faces"] > 0
    assert "embed_err" in result["checks"]
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
