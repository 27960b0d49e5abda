"""FULL with the multiclass selfie segmenter on the port's pipelined batch
path against the benchmark's plain reference, on the CPU at a test size.

The configuration is the benchmark's ``full_multiclass``
(``h100_bench/configs/full_multiclass.json``) cut to one block a network
stage (every width as published), on 120x180 noise frames.  Its seeded
networks (``h100_bench/harness/netspec.py``) go to the port through
``h100_bench/harness/system.py`` (``FaceDetector`` with
``SegmentationConfig(MULTICLASS)``), which runs them in
``ServingPipeline(detector, FULL, depth=2, with_segmentation=True)``; the
same graphs go to the plain reference, ``h100_bench/reference/``
(``segmentation.py``, ``pipeline.py``, ``interp.py``: plain PyTorch and
NumPy, nothing of the port), and the benchmark's checks
(``h100_bench/checks/faces.py``, ``masks.py``) compare the faces and the
six class planes frame by frame, float32 and uint8 masks alike.

Tolerances: the cell's own limits (``limits/full_multiclass.segpipe16.
json``: each lies between the largest reading of sound runs on the card
and the smallest of the reference with TF32 operands), and for the uint8
readback, which the cell does not run, ``mask_code_share`` 1e-3: a code
differs only where float32 rounding lands a value on a code boundary
(3.0e-6 of the codes here) or where the value is wrong (the reference
with TF32 operands flips 2.6e-3 here).  The same comparison of
the reference run with every convolution's and fully-connected layer's
operands rounded to TF32, in the program's place, must fail.
"""

from __future__ import annotations

import copy
import json
import os

import pytest
import torch

from face_detection_tflite_torch import FaceDetectionMode, ServingPipeline
from h100_bench.harness import check, drive, netspec, system
from h100_bench.harness.frames import make_frames
from h100_bench.reference.interp import round_tf32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "full_multiclass.segpipe16"
SEED = 2 ** 31 + 21
#: A batch of 4 frames, two in flight: 4 batches of the 16 frames.
BATCH, FRAMES = 4, 16
#: The uint8 readback's own number (module docstring).
UINT8_LIMITS = {"mask_code_share": 1e-3}


def _config(mask_dtype: str) -> dict:
    """``full_multiclass`` at one block a stage (the segmenter's last
    entry of each stage is its block count), with ``mask_dtype``."""
    with open(os.path.join(REPO, "h100_bench", "configs",
                           "full_multiclass.json")) as f:
        cfg = json.load(f)
    for spec in cfg["networks"].values():
        for key in ("blocks_per_stage", "blocks"):
            if spec and isinstance(spec.get(key), int):
                spec[key] = 1
        if spec and "stages" in spec:
            spec["stages"] = [list(s[:-1]) + [1] for s in spec["stages"]]
    cfg["segmentation"]["mask_dtype"] = mask_dtype
    return cfg


@pytest.fixture(scope="module")
def setup():
    """(networks with the detector calibrated, frames): the mix's 2.5
    passing anchors a frame, as the cell's traffic asks."""
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    cfg = _config("float32")
    nets = netspec.build_networks(cfg, SEED, cpu)
    frames = make_frames({"kind": "noise", "count": FRAMES, "height": 120,
                          "width": 180}, SEED, cpu)
    drive.calibrate(nets, frames, cfg, {"calibrate_anchors": 2.5}, cpu)
    return nets, frames


def _limits(cfg: dict) -> dict:
    return dict(check.load_limits(CELL), **UINT8_LIMITS)


def _pipelined(nets, frames, cfg) -> list[dict]:
    """Each frame's answer, ``{"faces", "mask"}``, from the pipeline."""
    det = system.make_detector(nets, cfg, torch.device("cpu"))
    try:
        with ServingPipeline(det, FaceDetectionMode.FULL, depth=2,
                             with_segmentation=True) as pipe:
            futures = [pipe.submit(frames[i:i + BATCH])
                       for i in range(0, len(frames), BATCH)]
            out = [pair for f in futures for pair in f.result(timeout=300)]
    finally:
        det.dispose()
    return [{"faces": faces, "mask": mask} for faces, mask in out]


def _judged(nets, frames, cfg, answers=None):
    """(correct, {number: value and limit}, {check: counts}): the
    program's answers (or the TF32 reference's, with ``answers`` None)
    against the fp32 reference."""
    hw = frames.shape[1:3]
    x = torch.from_numpy(frames)
    results = {}
    for name, mod in check.modules(cfg):
        ref = mod.reference(cfg, nets, torch.device("cpu"))
        with torch.inference_mode():
            want = ref(x)
            if answers is None:
                got = [mod.as_program(g, hw, cfg)
                       for g in ref(x, round_tf32)]
            else:
                got = [mod.port_answer(a, cfg) for a in answers]
        results[name] = mod.compare(list(zip(got, want)), hw, cfg)
    ok, shown = check.judge(results, _limits(cfg), cfg)
    return ok, shown, {k: r["counts"] for k, r in results.items()}


@pytest.mark.parametrize("mask_dtype", ["float32", "uint8"])
def test_the_pipeline_agrees_with_the_plain_reference(setup, mask_dtype):
    nets, frames = setup
    cfg = _config(mask_dtype)
    answers = _pipelined(nets, frames, cfg)
    assert len(answers) == FRAMES
    ok, shown, counts = _judged(nets, frames, cfg, answers)
    assert ok, (shown, counts)
    assert counts["faces"]["compared"] > FRAMES // 2
    assert counts["faces"]["faces"] >= FRAMES
    assert counts["masks"]["compared"] == FRAMES
    masks = ["mask_mismatch", "mask_err", "mask_class_share"]
    if mask_dtype == "uint8":
        masks.insert(2, "mask_code_share")
    assert [k for k in shown if k.startswith("mask")] == masks
    # Float32 on both sides of one CPU: the planes agree to float32's
    # rounding of the network's sums (beyond the uint8 readback's half
    # code), far inside the limit.
    assert shown["mask_err"]["value"] < 1e-6, shown


def test_tf32_operands_in_the_programs_place_fail(setup):
    """The reference with TF32 operands, handed over through the
    readback's rounding, fails the comparison: its planes move by more
    than ``mask_err``'s limit."""
    nets, frames = setup
    cfg = _config("float32")
    ok, shown, _ = _judged(nets, frames, cfg)
    assert not ok, shown
    assert shown["mask_err"]["value"] > shown["mask_err"]["limit"], shown


def test_the_configuration_is_the_benchmarks():
    """The test size changes only block counts: every width and the
    segmenter's model, classes and input are the benchmark's."""
    with open(os.path.join(REPO, "h100_bench", "configs",
                           "full_multiclass.json")) as f:
        full = json.load(f)
    cut = _config(full["segmentation"]["mask_dtype"])
    want = copy.deepcopy(full)
    for role, spec in want["networks"].items():
        if spec and "stages" in spec:
            assert [s[:-1] for s in spec["stages"]] == [
                s[:-1] for s in cut["networks"][role]["stages"]]
            spec["stages"] = cut["networks"][role]["stages"]
        for key in ("blocks_per_stage", "blocks"):
            if spec and key in spec:
                spec[key] = cut["networks"][role][key]
    assert cut == want
    assert cut["segmentation"]["model"] == "MULTICLASS"
    assert cut["networks"]["segmentation"]["classes"] == 6
