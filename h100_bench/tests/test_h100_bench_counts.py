"""The yardstick's counts: the frozen FLOP table against a count over the
benchmark's graphs, MobileFaceNet's size against Table 1 of its paper
and the upstream package's output layer, K2's bytes."""

from __future__ import annotations

import json
import math
import os

import torch

from bench_tiny import ROOT
from h100_bench.counts import flops, k2_bytes, kernels
from h100_bench.harness import manifest, netspec
from h100_bench.networks import mobilefacenet


def _config(name):
    with open(os.path.join(ROOT, "h100_bench", "configs", name)) as f:
        return json.load(f)


def _configs():
    return [_config(os.path.basename(c["file"]))
            for c in manifest.load_manifest(ROOT)["configs"]]


def test_flop_table_equals_a_count_over_the_frozen_graphs():
    for cfg in _configs():
        nets = netspec.build_networks(cfg, 0, torch.device("cpu"))
        for role, net in nets.items():
            spec = cfg["networks"][role]
            counted = (flops.graph_macs(net)
                       if isinstance(net, netspec.Graph) else
                       flops.mobilefacenet_macs(mobilefacenet.layers(spec),
                                                spec["input"]))
            assert flops.network_macs(spec["name"]) == counted, (
                cfg["name"], role)


def test_every_role_a_mode_runs_is_counted():
    for cfg in _configs():
        r = flops.runs(cfg["mode"])
        roles = set(r["per_frame"]) | set(r["per_face"])
        stated = {k for k, v in cfg["networks"].items() if v}
        assert stated <= roles, cfg["name"]
        assert "detector" in stated & set(r["per_frame"]), cfg["name"]


def test_mobilefacenet_is_table_1_with_the_packages_192_dim_output():
    spec = _config("full_embed.json")["networks"]["embedding"]
    params = mobilefacenet.build(netspec.Draws(0, "cpu"), spec)
    assert sum(v.size for v in params.values()) == spec["weights"] == \
        1_026_176
    # Chen et al. 2018, Table 1: a 128-dim output, 0.99 M weights and
    # 221 M multiply-adds a 112 px face (the output layer adds 0.03 M).
    table_1 = dict(spec, embedding_dim=128)
    params = mobilefacenet.build(netspec.Draws(0, "cpu"), table_1)
    assert round(sum(v.size for v in params.values()) / 1e4) == 99
    assert round(flops.mobilefacenet_macs(
        mobilefacenet.layers(table_1)) / 1e6) == 221
    assert round(flops.mobilefacenet_macs(
        mobilefacenet.layers(spec)) / 1e6) == 221


def test_per_frame_flops_count_faces_not_slab_slots():
    full, embed = _config("full.json"), _config("full_embed.json")

    def t(role, cfg=embed):
        return flops.network_macs(cfg["networks"][role]["name"])
    assert flops.per_frame_flops(full, 0) == 2 * t("detector")
    per_face = t("mesh") + 2 * t("iris") + t("blendshapes")
    assert flops.per_frame_flops(full, 3) == 2 * (t("detector") +
                                                  3 * per_face)
    assert flops.per_frame_flops(embed, 1) - flops.per_frame_flops(
        full, 1) == 2 * t("embedding")


def test_k2_bytes_count_each_source_pixel_once():
    out = 64
    # An upright ROI of 64 px inside the frame at scale 1: the taps touch
    # a 65 x 65 block (each sample and its right and lower neighbours).
    roi = torch.tensor([[100.0, 100.0, 64.0, 0.0]])
    b = k2_bytes.roi_bytes(480, 640, roi, out)
    assert b.tolist() == [65 * 65 * 3 + 20 + out * out * 12]
    # Downsampling a large ROI touches at most four pixels a sample.
    big = torch.tensor([[320.0, 240.0, 400.0, 0.3]])
    assert k2_bytes.roi_bytes(480, 640, big, out)[0] <= (
        4 * out * out * 3 + 20 + out * out * 12)
    # Taps outside the frame read nothing.
    corner = torch.tensor([[0.0, 0.0, 64.0, 0.0]])
    assert k2_bytes.roi_bytes(480, 640, corner, out)[0] < b[0]


def test_kernel_classes():
    assert kernels.kind("void warp_normalize_kernel<unsigned char>(...)") \
        == "k2"
    assert kernels.kind("detection_postprocess_kernel(float const*)") == "k1"
    assert kernels.kind("Memcpy HtoD (Pinned -> Device)") == "copy"
    assert kernels.kind("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32") \
        == "conv"
    assert kernels.kind("void cudnn::engines_precompiled::nchwToNhwcKernel"
                        "<float>") == "conv"
    assert kernels.kind("ampere_sgemm_128x64_tn") == "gemm"
    assert kernels.kind("void at::native::vectorized_elementwise_kernel<4,"
                        " at::native::CUDAFunctor_add<float>>") == "eltwise"


def test_peaks_are_the_published_h100_rates():
    p = flops.load(flops.PEAKS)
    assert math.isclose(p["fp32_flops_per_s"], 67e12)
    assert math.isclose(p["hbm_bytes_per_s"], 3.35e12)
