"""The detector variants other than BACK_CAMERA: FRONT_CAMERA and
SHORT_RANGE (128 px, 896 anchors), FULL (192 px, 2304 anchors on one
48x48 layer) and FULL_SPARSE (the full-range graph with its pruned
filters stored sparse behind DENSIFY).

Each variant's seeded network (one block a stage, calibrated on two small
frames) runs through the port's ``FaceDetector`` in FULL mode against the
JAX ``FaceDetector`` built on the same IRs (its ``convert_file`` and
``resolve_model_dir`` replaced for the test), and through the standalone
``FaceDetection`` against the JAX class.  Tolerances are those of
``tests/test_torch_pipeline.py``: the same faces, boxes and keypoints
within 1e-4 (normalized), scores within 1e-5, mesh and iris within 1e-2 px
or 1e-5 of the largest magnitude, blendshapes within 1e-4, head angles
within 0.1 degree; standalone detections within 1e-5 and scores 1e-6, as
``tests/test_torch_standalone.py`` holds BACK_CAMERA's.  FULL_SPARSE
equals FULL bit for bit where both carry the same weights."""

import os

import numpy as np
import pytest
import torch

from face_detection_tflite_torch import FaceDetection, FaceDetector
from face_detection_tflite_torch.convert.executor import convert_model
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.ops.detections import (_topk_candidates,
                                                        decode_detections)
from face_detection_tflite_torch.ops.letterbox import (letterbox_image,
                                                       letterbox_params)
from face_detection_tflite_torch.ops.nms import _iou_matrix
from face_detection_tflite_torch.pipeline.config import \
    FaceDetectionModel as Variant
from face_detection_tflite_torch.pipeline.programs import \
    _identify_detector_outputs
from face_detection_tflite_tpu.models import standalone as j_standalone
from face_detection_tflite_tpu.pipeline import detector as j_detector
from face_detection_tflite_tpu.pipeline.config import (
    MODEL_FILES, FaceDetectionModel as JVariant)

from .torch_parity import B, H, MAX_FACES, W, jax_ir, small_pipeline

VARIANTS = [Variant.FRONT_CAMERA, Variant.SHORT_RANGE, Variant.FULL,
            Variant.FULL_SPARSE]
_SETUPS: dict = {}


def _setup(variant):
    if variant not in _SETUPS:
        _SETUPS[variant] = small_pipeline(variant.value)
    return _SETUPS[variant]


def _tol(ref):
    return max(1e-2, 1e-5 * np.abs(ref).max())


@pytest.fixture
def jax_detector(monkeypatch):
    """Builds the JAX FaceDetector of a variant on the seeded JAX
    networks, loading them by file name."""
    monkeypatch.setenv("FDT_NO_COMPILE_CACHE", "1")

    def make(variant, jmodels, **kw):
        by_file = {MODEL_FILES[variant.value]: jmodels.detector,
                   MODEL_FILES["face_landmark"]: jmodels.mesh,
                   MODEL_FILES["iris_landmark"]: jmodels.iris,
                   MODEL_FILES["face_blendshapes"]: jmodels.blendshapes}
        monkeypatch.setattr(j_detector, "resolve_model_dir",
                            lambda model_dir=None: "seeded")
        monkeypatch.setattr(j_detector, "convert_file",
                            lambda path, precision="highest":
                            by_file[os.path.basename(path)])
        return j_detector.FaceDetector(JVariant(variant.value),
                                       max_faces=MAX_FACES, **kw)
    return make


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v.name)
def test_seed_is_not_marginal(variant):
    """No decoded score within 1e-4 of MIN_SCORE and no IoU among valid
    candidates within 1e-4 of the NMS threshold, so that an ulp between
    the packages flips no decision; a few candidates a frame."""
    frames, models, _ = _setup(variant)
    size = models.detector_input_size
    lbp = letterbox_params(H, W, size, size)
    with torch.inference_mode():
        raw_boxes, raw_scores = _identify_detector_outputs(models.detector(
            letterbox_image(torch.from_numpy(frames), lbp)))
        boxes, kp, scores, valid = decode_detections(
            raw_boxes, raw_scores, models.anchors, float(size))
        tb, _, _, tv = _topk_candidates(boxes, kp, scores, valid,
                                        models.anchors.shape[0])
        iou = _iou_matrix(tb)
    assert (scores - 0.5).abs().min().item() >= 1e-4
    for i in range(B):
        n = int(tv[i].sum())
        assert 2 <= n <= 40
        pair = iou[i, :n, :n][~torch.eye(n, dtype=torch.bool)]
        assert (pair - 0.3).abs().min().item() >= 1e-4


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v.name)
def test_detector_full_mode_matches_jax(variant, jax_detector):
    """``FaceDetector(model=v)`` in FULL (speculative dispatch with its
    overflow re-run, int16 landmark readback) against the JAX detector on
    the same networks and frames (one program, no speculation)."""
    frames, models, jmodels = _setup(variant)
    anchors = {Variant.FULL: 2304, Variant.FULL_SPARSE: 2304}.get(variant,
                                                                  896)
    assert models.anchors.shape == (anchors, 2)
    det = FaceDetector(variant, models=models, device="cpu",
                       max_faces=MAX_FACES)
    ref_det = jax_detector(variant, jmodels, adaptive=False)
    refs = ref_det.detect_faces_batch(frames)
    for _ in range(2):  # the first call overflows the 1-face bucket
        faces = det.detect_faces_batch(frames)
    assert sum(len(f) for f in faces) >= B
    for got, ref in zip(faces, refs):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            gb, rb = g.bounding_box, r.bounding_box
            assert np.abs(np.subtract([gb.xmin, gb.ymin, gb.xmax, gb.ymax],
                                      [rb.xmin, rb.ymin, rb.xmax, rb.ymax])
                          ).max() <= 1e-4
            assert abs(g.score - r.score) <= 1e-5
            assert np.abs(g.detection_data.keypoints_xy
                          - np.asarray(r.detection_data.keypoints_xy)
                          ).max() <= 1e-4
            assert np.abs(g.mesh.points - r.mesh.points).max() <= \
                _tol(r.mesh.points)
            assert np.abs(g.iris_points - r.iris_points).max() <= \
                _tol(r.iris_points)
            assert np.abs(g.blendshapes.scores - r.blendshapes.scores
                          ).max() <= 1e-4
            ga, ra = g.head_euler_angles, r.head_euler_angles
            assert np.abs(np.subtract([ga.x, ga.y, ga.z],
                                      [ra.x, ra.y, ra.z])).max() <= 0.1
    det.dispose()


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v.name)
def test_face_detection_matches_jax(variant, monkeypatch):
    """Standalone ``FaceDetection(variant=v)`` against the JAX class."""
    frames, models, jmodels = _setup(variant)
    monkeypatch.setattr(j_standalone, "_resolve", lambda name, _dir: name)
    monkeypatch.setattr(j_standalone, "convert_file",
                        lambda name, precision: jmodels.detector)
    port = FaceDetection(variant, model=models.detector, device="cpu",
                         max_detections=8)
    ref = j_standalone.FaceDetection(JVariant(variant.value),
                                     max_detections=8)
    for img in frames:
        got, want = port(img), ref(img)
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            gb, wb = g.bounding_box, w.bounding_box
            assert np.abs(np.subtract([gb.xmin, gb.ymin, gb.xmax, gb.ymax],
                                      [wb.xmin, wb.ymin, wb.xmax, wb.ymax])
                          ).max() <= 1e-5
            assert np.abs(g.keypoints_xy - np.asarray(w.keypoints_xy)
                          ).max() <= 1e-5
            assert abs(g.score - w.score) <= 1e-6


def test_full_sparse_equals_full():
    """The sparse graph densifies to the dense graph's weights: the
    detector's outputs and the faces are equal bit for bit."""
    frames, full, _ = _setup(Variant.FULL)
    _, sparse, _ = _setup(Variant.FULL_SPARSE)
    x = letterbox_image(torch.from_numpy(frames),
                        letterbox_params(H, W, 192, 192))
    with torch.inference_mode():
        for a, b in zip(full.detector(x), sparse.detector(x)):
            assert torch.equal(a, b)
    got = [FaceDetector(v, models=m, device="cpu", max_faces=MAX_FACES)
           .detect_faces_batch(frames)
           for v, m in ((Variant.FULL, full), (Variant.FULL_SPARSE, sparse))]
    for fa, fb in zip(*got):
        assert [f.to_dict(include_mesh=True) for f in fa] == \
            [f.to_dict(include_mesh=True) for f in fb]


def test_sparse_ir_stores_the_pruned_filters_sparse():
    """Every pruned pointwise filter of the full-range graph is a sparse
    constant behind DENSIFY in FULL_SPARSE, and both executors densify it
    to the dense graph's filter."""
    from face_detection_tflite_tpu.convert import executor as j_exec
    dense = random_init.blazeface_full_range_ir(5, blocks_per_stage=1)
    sparse = random_init.sparse_detector_ir(dense)
    densify = [op for op in sparse.ops if op.name == "DENSIFY"]
    pruned = [op.inputs[1] for op in dense.ops if op.name == "CONV_2D"
              and (dense.tensors[op.inputs[1]].data == 0).any()]
    assert len(densify) == len(pruned) >= 6
    for op in densify:
        t = sparse.tensors[op.inputs[0]]
        assert t.sparsity is not None
        assert t.data.size == np.count_nonzero(dense.tensors[t.index].data)
    x = np.random.default_rng(0).uniform(-1, 1, (1, 192, 192, 3)
                                         ).astype(np.float32)
    want = convert_model(dense)(torch.from_numpy(x))
    got = convert_model(sparse)(torch.from_numpy(x))
    jm = j_exec.convert_model(jax_ir(sparse))
    jgot = jm.fn(jm.params, x)
    for w, g, j in zip(want, got, jgot):
        assert torch.equal(w, g)
        assert np.abs(np.asarray(j) - w.numpy()).max() <= \
            2e-6 * np.abs(w.numpy()).max()


@pytest.mark.parametrize("name,make,size,params", [
    ("front", random_init.blazeface_front_ir, 128, 101_390),
    ("full_range", random_init.blazeface_full_range_ir, 192, 259_649)])
def test_published_sizes(name, make, size, params):
    """Full depth: the input sizes and anchor counts of the published
    graphs, and weight counts sized to their files (front: 229,032 B in
    fp16; full range: 1,083,984 B read as fp32)."""
    m = convert_model(make(0))
    assert m.input_shapes[0] == (1, size, size, 3)
    assert m.num_params == params
    anchors = 896 if size == 128 else 2304
    assert [tuple(s) for s in m.output_shapes] == [(1, anchors, 16),
                                                   (1, anchors, 1)]


def test_models_must_match_the_variant():
    frames, models, _ = _setup(Variant.FRONT_CAMERA)
    with pytest.raises(ValueError, match="front"):
        FaceDetector(Variant.FULL, models=models, device="cpu")
