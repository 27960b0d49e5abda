"""The port's STANDARD pipeline against the JAX package's on the same
seeded networks and frames.

Both packages run the same calibrated random-init IRs (the port carries
the JAX params through ``params_from_jax``), on two small frames with a
4-face slab.  Valid masks and ``det_count`` must be identical; boxes and
keypoints agree within 1e-4 (normalized); the mesh within 1e-2 px or 1e-5
of the slab's largest magnitude, whichever is larger."""

import jax
import numpy as np
import pytest
import torch

from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
from face_detection_tflite_torch.ops.detections import (_topk_candidates,
                                                        decode_detections)
from face_detection_tflite_torch.ops.letterbox import (letterbox_image,
                                                       letterbox_params)
from face_detection_tflite_torch.ops.nms import _iou_matrix
from face_detection_tflite_torch.pipeline.programs import (
    PipelineModels, build_pipeline_program)
from face_detection_tflite_tpu.pipeline import programs as j_programs
from face_detection_tflite_tpu.pipeline.config import \
    FaceDetectionMode as JMode

from .torch_parity import B, H, MAX_FACES, W, small_pipeline


@pytest.fixture(scope="module")
def setup():
    return small_pipeline()


def _jax_slab(jmodels, frames, **kw):
    fn = jax.jit(j_programs.build_pipeline_program(
        jmodels, H, W, JMode.STANDARD, max_faces=MAX_FACES, **kw))
    return {k: np.asarray(v) for k, v in fn(jmodels.params, frames).items()}


def _assert_slabs_match(got, ref):
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    for key in ("det_valid", "det_count"):
        if key in ref:
            np.testing.assert_array_equal(got[key], ref[key])
    for key in ("boxes", "raw_keypoints", "det_boxes", "det_raw_keypoints"):
        if key in ref:
            assert np.abs(got[key] - ref[key]).max() <= 1e-4, key
    for key in ("scores", "mesh_scores", "det_scores"):
        if key in ref:
            assert np.abs(got[key] - ref[key]).max() <= 1e-5, key
    tol = max(1e-2, 1e-5 * np.abs(ref["mesh"]).max())
    assert np.abs(got["mesh"] - ref["mesh"]).max() <= tol


def test_seed_is_not_marginal(setup):
    """No decoded score within 1e-4 of MIN_SCORE and no IoU among valid
    candidates within 1e-4 of the NMS threshold: a marginal seed would
    let 1-ulp differences between the packages flip a decision."""
    frames, models, _ = setup
    lbp = letterbox_params(H, W, 256, 256)
    with torch.inference_mode():
        raw_boxes, raw_scores = models.detector(
            letterbox_image(torch.from_numpy(frames), lbp))
        boxes, kp, scores, valid = decode_detections(
            raw_boxes, raw_scores, models.anchors, 256.0)
        tb, _, _, tv = _topk_candidates(boxes, kp, scores, valid, 896)
        iou = _iou_matrix(tb)
    assert (scores - 0.5).abs().min().item() >= 1e-4
    for i in range(B):
        n = int(tv[i].sum())
        assert 2 <= n <= 40
        pair = iou[i, :n, :n][~torch.eye(n, dtype=torch.bool)]
        assert (pair - 0.3).abs().min().item() >= 1e-4


@pytest.mark.parametrize("face_slab", [None, 2])
def test_standard_program_matches_jax(setup, face_slab):
    frames, models, jmodels = setup
    prog = build_pipeline_program(models, H, W, FaceDetectionMode.STANDARD,
                                  max_faces=MAX_FACES, face_slab=face_slab)
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in prog(torch.from_numpy(frames)).items()}
    ref = _jax_slab(jmodels, frames, face_slab=face_slab)
    assert got["mesh"].shape == (B, face_slab or MAX_FACES, 468, 3)
    assert got["valid"].any(axis=1).all()
    _assert_slabs_match(got, ref)


def test_detector_matches_jax_slab(setup):
    """FaceDetector (speculative dispatch, overflow re-run, int16 mesh
    readback) materializes the faces of the JAX slab."""
    frames, models, jmodels = setup
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES)
    ref = _jax_slab(jmodels, frames, min_score=0.5)
    for _ in range(2):  # first call overflows the 1-face bucket
        faces = det.detect_faces_batch(frames, FaceDetectionMode.STANDARD)
    assert len(faces) == B
    for i in range(B):
        keep = ref["valid"][i] & (ref["mesh_scores"][i] >= 0.5)
        assert len(faces[i]) == int(keep.sum()) >= 1
        tol = max(1e-2, 1e-5 * np.abs(ref["mesh"]).max())
        for face, d in zip(faces[i], np.flatnonzero(keep)):
            bb = face.bounding_box
            assert np.abs(np.asarray([bb.xmin, bb.ymin, bb.xmax, bb.ymax])
                          - ref["boxes"][i, d]).max() <= 1e-4
            assert np.abs(face.detection_data.keypoints_xy
                          - ref["raw_keypoints"][i, d]).max() <= 1e-4
            assert np.abs(face.mesh.points - ref["mesh"][i, d]).max() <= tol
            assert face.mesh.points.shape == (468, 3)
    one = det.detect_faces(frames[0], FaceDetectionMode.STANDARD)
    assert len(one) == len(faces[0])
    det.dispose()
    with pytest.raises(RuntimeError, match="dispose"):
        det.detect_faces_batch(frames)


@pytest.mark.parametrize("options", [
    {"adaptive": False}, {"quantized_readback": False,
                          "detailed_timings": True},
    {"bucket_images": True}, {"bucket_batches": False,
                               "num_candidates": 64}],
    ids=lambda o: "-".join(o))
def test_detector_options_match_jax_slab(setup, options):
    """Three frames (the batch pads to 4) through the other dispatch,
    readback and bucketing paths.  Bucketed frames pad bottom/right to
    256x256, so the reference is the JAX slab of the padded frames, with
    normalized coordinates rescaled to the original size."""
    frames, models, jmodels = setup
    frames3 = frames[[0, 1, 0]]
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                       **options)
    faces = det.detect_faces_batch(frames3, FaceDetectionMode.STANDARD)
    if options.get("bucket_images"):
        padded = np.zeros((3, 256, 256, 3), np.uint8)
        padded[:, :H, :W] = frames3
        fn = jax.jit(j_programs.build_pipeline_program(
            jmodels, 256, 256, JMode.STANDARD, max_faces=MAX_FACES,
            min_score=0.5))
        ref = {k: np.asarray(v)
               for k, v in fn(jmodels.params, padded).items()}
        scale = np.asarray([256 / W, 256 / H], np.float32)
        ref["boxes"] = ref["boxes"] * np.tile(scale, 2)
        ref["raw_keypoints"] = ref["raw_keypoints"] * scale
    else:
        ref = _jax_slab(jmodels, frames3, min_score=0.5,
                        num_candidates=options.get("num_candidates"))
    tol = max(1e-2, 1e-5 * np.abs(ref["mesh"]).max())
    for i in range(3):
        keep = np.flatnonzero(ref["valid"][i] & (ref["mesh_scores"][i] >= 0.5))
        assert len(faces[i]) == len(keep)
        for face, d in zip(faces[i], keep):
            bb = face.bounding_box
            assert np.abs(np.asarray([bb.xmin, bb.ymin, bb.xmax, bb.ymax])
                          - ref["boxes"][i, d]).max() <= 1e-4
            assert np.abs(face.mesh.points - ref["mesh"][i, d]).max() <= tol
    if options.get("detailed_timings"):
        assert "compute_wait" in det.timings.report()


def test_detector_surface_raises_for_unported_features(setup):
    _, models, _ = setup
    for kw in ({"seg_device": "cuda:1"}, {"data_parallel": True},
               {"precision": "high"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            FaceDetector(models=models, device="cpu", **kw)
    # Embeddings are ported: the fused stage needs FULL mode and a model.
    with pytest.raises(ValueError, match="FULL"):
        build_pipeline_program(models, H, W, FaceDetectionMode.STANDARD,
                               with_embeddings=True)
    bare = PipelineModels(models.detector, "back", mesh=models.mesh,
                          device="cpu", iris=models.iris,
                          blendshapes=models.blendshapes)
    with pytest.raises(ValueError, match="embedding model"):
        build_pipeline_program(bare, H, W, with_embeddings=True)


def test_detector_full_mode_runs(setup):
    """FULL is the default mode: every face carries 152 iris points, 52
    coefficients in [0, 1] and head angles."""
    frames, models, _ = setup
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES)
    faces = det.detect_faces_batch(frames)
    assert [len(f) for f in faces] == \
        [len(f) for f in det.detect_faces_batch(frames,
                                                FaceDetectionMode.FULL)]
    assert sum(len(f) for f in faces) >= B
    for face in (f for per_image in faces for f in per_image):
        assert face.iris_points.shape == (152, 3)
        assert face.eyes is not None and face.eyes.right_eye is not None
        scores = face.blendshapes.scores
        assert len(scores) == 52 and 0.0 <= min(scores) <= max(scores) <= 1
        assert face.head_euler_angles is not None
    with pytest.raises(ValueError, match="iris"):
        build_pipeline_program(
            type(models)(models.detector, "back", mesh=models.mesh,
                         device="cpu"), H, W, FaceDetectionMode.FULL)
