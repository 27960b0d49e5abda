"""A configuration that segments, defined here at a test size: FULL with
a selfie segmenter on ``detect_faces_with_segmentation_batch``, its masks
compared by the ``masks`` check beside the faces.  The interpreter's
segmenter ops against the port's executor, the segmenters' counts, the
control and the faults a mask can have; and the manifest's cells read the
same numbers through the checks found by name as through the face
comparison alone."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from bench_tiny import run_tiny, tiny
from face_detection_tflite_torch.convert.executor import convert_model
from face_detection_tflite_torch.models import segmentation as seg_mod
from h100_bench import control
from h100_bench.checks import faces
from h100_bench.counts import flops
from h100_bench.harness import check, drive, manifest, netspec, system
from h100_bench.networks import selfie_segmenter
from h100_bench.reference.interp import Network, round_tf32
from test_h100_bench_manifest import check_widths

#: The port's seeded segmenters (``models/random_init.py``: ``SEGMENTER``,
#: the landscape input, ``MULTICLASS_SEGMENTER``), widths at the size of
#: the published files, and their weights: float16 filters and biases and
#: the float32 hard-sigmoid scalars.
GENERAL = {"builder": "selfie_segmenter", "name": "selfie_general",
           "in_hw": [256, 256], "classes": 1, "stem": 16, "stages": [
               [16, 16, 3, 2, True, False, 1], [72, 24, 3, 2, False, False, 2],
               [96, 40, 5, 2, True, True, 3], [128, 48, 5, 2, True, True, 2]]}
SPECS = {
    "selfie_general": (GENERAL, 119_413),
    "selfie_landscape": (dict(GENERAL, name="selfie_landscape",
                              in_hw=[144, 256]), 119_413),
    "selfie_multiclass": ({
        "builder": "selfie_segmenter", "name": "selfie_multiclass",
        "in_hw": [256, 256], "classes": 6, "stem": 24, "stages": [
            [48, 32, 3, 2, True, False, 2], [144, 64, 3, 2, False, False, 3],
            [384, 160, 5, 2, True, True, 4],
            [1024, 448, 5, 2, True, True, 5]]}, 8_168_956)}

NAME = "full_segment.test"

#: Limits of the test cell: the face limits of ``full.stream16``; the
#: mask limits between the CPU's sound readings at the test size (mask_err
#: 3e-8 to 7e-8, mask_code_share 1e-6 to 1e-5, mask_class_share 0) and
#: the TF32 control's (mask_err 2e-4 to 5e-4, mask_code_share 4e-3 to
#: 6e-3).
MASK_LIMITS = {"mask_mismatch": 0, "mask_err": 1e-5, "mask_code_share": 1e-3,
               "mask_class_share": 1e-4}


def segment_cell(mask_dtype: str = "float32", classes: int = 1) -> dict:
    """FULL + a selfie segmenter (the general one, or with six classes
    the MULTICLASS model on the general's stages) on the combined call,
    at a test size."""
    base = manifest.cell(manifest.load_manifest(), "full.stream16")
    cfg = copy.deepcopy(base["config"])
    cfg.update(name="full_segment", answers=["faces", "masks"],
               segmentation={"model": "MULTICLASS" if classes > 1
                             else "GENERAL", "mask_dtype": mask_dtype,
                             "precision": "highest"})
    cfg["networks"]["segmentation"] = dict(GENERAL, classes=classes)
    mix = dict(base["mix"], loop="segment_batch")
    del mix["depth"]
    work = dict(base["workload"], name=NAME, config="full_segment")
    return tiny(dict(base, workload=work, config=cfg, mix=mix))


@pytest.fixture
def limits(tmp_path, monkeypatch):
    lim = dict(check.load_limits("full.stream16"), **MASK_LIMITS)
    (tmp_path / f"{NAME}.json").write_text(json.dumps({"limits": lim}))
    monkeypatch.setattr(check, "LIMITS", str(tmp_path))
    return lim


def test_the_segmenting_configuration_states_its_widths():
    for classes in (1, 6):
        cfg = copy.deepcopy(segment_cell(classes=classes)["config"])
        cfg["networks"]["segmentation"]["stages"] = GENERAL["stages"]
        check_widths(cfg)


@pytest.mark.parametrize("mask_dtype", ["float32", "uint8"])
def test_a_segmenting_cell_runs_correct(limits, mask_dtype):
    result, err = run_tiny(segment_cell(mask_dtype))
    assert result["correct"], err
    masks = ["mask_mismatch", "mask_err"] + (
        ["mask_code_share"] if mask_dtype == "uint8" else [])
    assert list(result["checks"]) == faces.names(
        segment_cell()["config"]) + masks
    for k in masks:
        assert result["checks"][k]["limit"] == limits[k]
        assert f"check {k}: " in "\n".join(err)
    assert result["sample"]["masks"]["compared"] > 0
    assert result["sample"]["faces"]["faces"] > 0
    assert result["failed"] == 0


def _shifted(masks):
    for m in masks:
        m.data = m.data + np.float32(1 / 255)


def _swapped(masks):
    for m in masks:
        m.class_data = m.class_data[..., [0, 2, 1, 3, 4, 5]]


def _padding_off(masks):
    for m in masks:
        t, b, left, r = m.padding
        m.padding = (t + 1 / m.height, b, left, r)


@pytest.mark.parametrize("fault, mask_dtype, classes, fails", [
    (_shifted, "uint8", 1, "mask_code_share"),
    (_swapped, "float32", 6, "mask_class_share"),
    (_padding_off, "float32", 1, "mask_mismatch")])
def test_a_broken_mask_is_not_correct(limits, monkeypatch, fault, mask_dtype,
                                      classes, fails):
    """A mask altered where the program makes it, after the readback."""
    real = seg_mod.SelfieSegmentation.materialize

    def broken(self, handle):
        masks = real(self, handle)
        fault(masks)
        return masks
    monkeypatch.setattr(seg_mod.SelfieSegmentation, "materialize", broken)
    result, err = run_tiny(segment_cell(mask_dtype, classes))
    assert not result["correct"], err
    shown = result["checks"][fails]
    assert shown["value"] > shown["limit"], err
    if fails == "mask_mismatch":
        assert result["failed"] > 0


def test_the_control_fails_a_mask_number_with_six_classes(limits):
    torch.set_num_threads(2)
    cell = segment_cell(classes=6)
    r = control.readings(cell, 2 ** 31 + 3, torch.device("cpu"), round_tf32)
    ok, shown = check.judge(r["results"], limits, cell["config"])
    assert not ok
    assert any(shown[k]["value"] > shown[k]["limit"]
               for k in ("mask_err", "mask_class_share")), shown
    # The fp32 reference against itself reads nothing beyond float32's
    # rounding of the person plane, one less the background.
    same = control.readings(cell, 2 ** 31 + 3, torch.device("cpu"),
                            None)["results"]["masks"]["numbers"]
    assert same.pop("mask_err") < 1e-7
    assert all(v == 0 for v in same.values()), same


@pytest.mark.parametrize("name", sorted(SPECS))
def test_a_segmenters_counts(name):
    """Its MAC file is the count over its graph, and its weights are the
    port's seeded segmenter's."""
    spec, weights = SPECS[name]
    graph = selfie_segmenter.build(netspec.Draws(0, "cpu"), spec)
    assert flops.network_macs(name) == flops.graph_macs(graph)
    assert sum(t.data.size for t in graph.tensors if t.data is not None
               and t.data.dtype != np.int32) == weights


def _one_op(name, x_shape, out_shape, inputs=(), **options):
    g = netspec.Builder(netspec.Draws(7, "cpu"))
    x = g.tensor(x_shape)
    consts = [g.const(c) for c in inputs]
    if name == "TRANSPOSE_CONV":
        ins = [consts[0], x, consts[1]]
    else:
        ins = [x] + consts
    return g.graph([x], [g.op(name, ins, out_shape, **options)], name)


def _filter(*shape):
    return np.random.default_rng(3).normal(0, 0.3, shape).astype(np.float32)


OPS = {
    "resize_half_pixel": _one_op(
        "RESIZE_BILINEAR", (1, 5, 8, 3), (1, 9, 16, 3), size=[9, 16],
        align_corners=False, half_pixel_centers=True),
    "resize_align_corners": _one_op(
        "RESIZE_BILINEAR", (1, 5, 8, 3), (1, 11, 13, 3), size=[11, 13],
        align_corners=True, half_pixel_centers=False),
    "resize_plain": _one_op(
        "RESIZE_BILINEAR", (1, 9, 8, 3), (1, 4, 13, 3), size=[4, 13],
        align_corners=False, half_pixel_centers=False),
    "transpose_conv": _one_op(
        "TRANSPOSE_CONV", (1, 5, 7, 4), (1, 10, 14, 3),
        (_filter(3, 3, 3, 4), _filter(3)), output_shape=[1, 10, 14, 3],
        stride=2, padding=netspec.PADDING_SAME),
    "transpose_conv_bias": _one_op(
        "CUSTOM:Convolution2DTransposeBias", (1, 5, 7, 4), (1, 10, 14, 6),
        (_filter(6, 2, 2, 4), _filter(6)), stride=2,
        padding=netspec.PADDING_SAME),
    "hard_swish": _one_op("HARD_SWISH", (1, 6, 6, 5), (1, 6, 6, 5)),
    "global_average_pool": _one_op(
        "AVERAGE_POOL_2D", (1, 5, 8, 3), (1, 1, 1, 3), padding=1,
        filter=[5, 8], stride=[5, 8]),
    "average_pool_same": _one_op(
        "AVERAGE_POOL_2D", (1, 5, 7, 3), (1, 3, 4, 3),
        padding=netspec.PADDING_SAME, filter=[3, 3], stride=[2, 2]),
    "softmax": _one_op("SOFTMAX", (1, 4, 4, 6), (1, 4, 4, 6), beta=1.0),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_the_interpreter_agrees_with_the_port_on_the_segmenter_ops(name):
    graph = OPS[name]
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 2.0, graph.tensors[graph.inputs[0]].shape).astype(np.float32))
    x = x.expand(3, *x.shape[1:]).contiguous()
    (want,) = Network(graph, "cpu")(x)
    got = convert_model(system.to_ir(graph))(x)[0]
    assert got.shape == want.shape
    # Equal to float32 rounding: the two compute the taps' weights and
    # the window sums in their own order.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_transposed_convolutions_count_each_input_value_once_a_tap():
    for name in ("TRANSPOSE_CONV", "transpose_conv_bias"):
        graph = OPS["transpose_conv" if name == "TRANSPOSE_CONV" else name]
        cout = graph.tensors[graph.outputs[0]].shape[3]
        k = 3 if name == "TRANSPOSE_CONV" else 2
        assert flops.graph_macs(graph) == 5 * 7 * 4 * k * k * cout


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest.load_manifest()["workloads"]])
def test_checks_found_by_name_read_what_the_face_comparison_reads(
        monkeypatch, workload):
    """The checks of a manifest cell's tiny run equal the face comparison
    over the same answers, paired and judged as before the checks were
    found by name: a bare list of faces a frame, the face numbers, and
    ``embed_err`` only where the configuration embeds."""
    seen = {}
    real = drive.check_outputs

    def keep(setup, chosen, limits, **kw):
        seen.update(chosen=chosen, limits=limits, setup=setup,
                    res=real(setup, chosen, limits, **kw))
        return seen["res"]
    monkeypatch.setattr(drive, "check_outputs", keep)
    result, _ = run_tiny(workload)
    setup, by_frame = seen["setup"], seen["res"]["ref"]
    pairs = [([faces.port_face(f) for f in got], by_frame[i])
             for idx, frame_faces in seen["chosen"].values()
             for i, got in zip(idx, frame_faces)]
    old = faces.compare(pairs, setup.frames.shape[1:3], setup.config)
    names = [k for k in faces.NUMBERS
             if "embedding" in setup.nets or k != "embed_err"]
    assert result["checks"] == {k: {"value": old["numbers"][k],
                                    "limit": seen["limits"][k]}
                                for k in names}
    assert result["failed"] == old["counts"]["bad_frames"]
