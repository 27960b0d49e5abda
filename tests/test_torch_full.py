"""The port's FULL mode against the JAX package's on the same seeded
networks and frames: blendshape packing, the FULL geometry, the FULL
program (direct and speculative), blendshape NaN sanitizing and the
FaceDetector's FULL faces.

Tolerances: the packing, iris centers, rolls and face ROIs are exact; eye
ROIs within 1 ulp; the iris back-projection within 1 ulp of its largest
magnitude and head angles within 1 ulp of 180 degrees (XLA's and
PyTorch's sin, cos, atan2 and asin differ by an ulp).  Through the
program: valid, blendshapes_valid and det_count equal; boxes, keypoints
and iris-refined keypoints within 1e-4; mesh and iris within 1e-2 px or
1e-5 of the slab's largest magnitude; blendshapes within 1e-4
(``docs/PARITY.md``); head angles within 0.1 degree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
from face_detection_tflite_torch.convert.executor import convert_model
from face_detection_tflite_torch.convert.tflite import ModelIR, OpIR, TensorIR
from face_detection_tflite_torch.pipeline import geometry as tg
from face_detection_tflite_torch.pipeline.blendshape_input import (
    pack_blendshape_input, pack_indices)
from face_detection_tflite_torch.pipeline.programs import (
    PipelineModels, build_pipeline_program)
from face_detection_tflite_tpu.convert.executor import \
    convert_model as j_convert
from face_detection_tflite_tpu.pipeline import geometry as jg
from face_detection_tflite_tpu.pipeline import programs as j_programs
from face_detection_tflite_tpu.pipeline.blendshape_input import \
    pack_blendshape_input as j_pack
from face_detection_tflite_tpu.pipeline.blendshape_input import \
    pack_indices as j_pack_indices
from face_detection_tflite_tpu.pipeline.config import \
    FaceDetectionMode as JMode

from .torch_parity import B, H, MAX_FACES, W, jax_ir, small_pipeline

_rng = np.random.default_rng(2024)


@pytest.fixture(scope="module")
def setup():
    return small_pipeline()


def _mesh_tol(ref):
    return max(1e-2, 1e-5 * np.abs(ref).max())


def test_pack_tables_match_jax():
    for mine, ref in zip(pack_indices(), j_pack_indices()):
        np.testing.assert_array_equal(mine, ref)


def test_pack_blendshape_input_matches_jax():
    mesh = _rng.uniform(-50, 1300, (2, 3, 468, 3)).astype(np.float32)
    iris = _rng.uniform(-50, 1300, (2, 3, 152, 3)).astype(np.float32)
    got = pack_blendshape_input(torch.from_numpy(mesh),
                                torch.from_numpy(iris)).numpy()
    ref = np.asarray(j_pack(jnp.asarray(mesh), jnp.asarray(iris)))
    assert got.shape == (2, 3, 146, 2)
    np.testing.assert_array_equal(got, ref)


def _ulps(got, ref) -> int:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return int(np.abs(got.view(np.int32).astype(np.int64)
                      - ref.view(np.int32).astype(np.int64)).max())


def _degenerate_mesh():
    mesh = _rng.uniform(0, 1000, (3, 4, 468, 3)).astype(np.float32)
    mesh[0, 1, 152] = mesh[0, 1, 10]            # chin on the forehead
    mesh[1, 2, 454] = mesh[1, 2, 234]            # cheeks coincide
    mesh[2, 0, 152] = mesh[2, 0, 10] + (mesh[2, 0, 454] - mesh[2, 0, 234])
    return mesh                                  # down parallel to right


def _geometry_case(name):
    """(port result, JAX result) of one geometry function on seeded
    inputs, as numpy arrays."""
    t, j = torch.from_numpy, jnp.asarray
    if name in ("eye_rois", "head_pose"):
        mesh = _rng.uniform(0, 1000, (3, 4, 468, 3)).astype(np.float32)
        fn = "eye_rois_from_mesh" if name == "eye_rois" else \
            "head_euler_angles_from_mesh"
        return (getattr(tg, fn)(t(mesh)), getattr(jg, fn)(j(mesh)))
    if name == "head_pose_degenerate":
        mesh = _degenerate_mesh()
        return (tg.head_euler_angles_from_mesh(t(mesh)),
                jg.head_euler_angles_from_mesh(j(mesh)))
    if name == "iris_transform":
        pts = _rng.uniform(-0.2, 1.2, (2, 6, 76, 3)).astype(np.float32)
        roi = [_rng.uniform(lo, hi, (2, 6)).astype(np.float32)
               for lo, hi in ((0, 1280), (0, 853), (1, 200), (-3.2, 3.2))]
        right = np.tile([False, True], (2, 3))[..., None]
        return (tg.transform_iris_norm_to_absolute(
                    t(pts), *map(t, roi), t(right)),
                jg.transform_iris_norm_to_absolute(j(pts), *map(j, roi),
                                                   j(right)))
    if name == "roll":
        a, b = (_rng.uniform(0, 500, (5, 2)).astype(np.float32)
                for _ in range(2))
        return tg.roll_from_eyes(t(a), t(b)), jg.roll_from_eyes(j(a), j(b))
    if name == "face_roi":
        box = np.sort(_rng.uniform(0, 1, (6, 2, 2)), 1).reshape(6, 4)
        box = box[:, [0, 2, 1, 3]].astype(np.float32)
        return (tg.face_detection_to_roi(t(box), 0.6),
                jg.face_detection_to_roi(j(box), 0.6))
    if name == "iris_center":
        pts = _rng.uniform(0, 100, (3, 4, 5, 3)).astype(np.float32)
    else:  # "iris_center_tie": points 0 and 1 both sqrt(2) from (1, 1)
        pts = np.zeros((2, 5, 3), np.float32)
        pts[:, :, :2] = [[2, 0], [0, 2], [-2, 0], [0, -2], [5, 5]]
        pts[1, :, :2] = pts[1, [1, 0, 2, 3, 4], :2]
        pts[..., 2] = np.arange(5)
    return (tg.iris_center_from_points(t(pts)),
            jg.iris_center_from_points(j(pts)))


@pytest.mark.parametrize("name", [
    "eye_rois", "head_pose", "head_pose_degenerate", "iris_transform",
    "roll", "face_roi", "iris_center", "iris_center_tie"])
def test_geometry_matches_jax(name):
    got, ref = _geometry_case(name)
    got = [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype == np.float32
        if name.startswith("head_pose"):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
            assert np.nanmax(np.abs(g - r)) <= np.spacing(np.float32(180))
        elif name == "iris_transform":
            assert np.abs(g - r).max() <= np.spacing(np.abs(r).max())
        elif name == "eye_rois":
            assert _ulps(g, r) <= 1
        else:
            np.testing.assert_array_equal(g, r)
    if name == "head_pose_degenerate":
        nan_faces = np.isnan(got[0]).all(-1)
        assert nan_faces[0, 1] and nan_faces[1, 2] and nan_faces[2, 0]
        assert nan_faces.sum() == 3
    if name == "iris_center_tie":
        np.testing.assert_array_equal(got[0][:, 2], [0, 0])


def _jax_full(jmodels, frames, **kw):
    fn = jax.jit(j_programs.build_pipeline_program(
        jmodels, H, W, JMode.FULL, max_faces=MAX_FACES, **kw))
    return {k: np.asarray(v) for k, v in fn(jmodels.params, frames).items()}


def _assert_full_match(got, ref):
    assert set(got) == set(ref)
    for key in ("valid", "blendshapes_valid", "det_valid", "det_count"):
        if key in ref:
            np.testing.assert_array_equal(got[key], ref[key], key)
    for key in ("boxes", "raw_keypoints", "keypoints", "det_boxes",
                "det_raw_keypoints", "blendshapes"):
        if key in ref:
            assert np.abs(got[key] - ref[key]).max() <= 1e-4, key
    for key in ("scores", "mesh_scores", "det_scores"):
        if key in ref:
            assert np.abs(got[key] - ref[key]).max() <= 1e-5, key
    for key in ("mesh", "iris"):
        assert np.abs(got[key] - ref[key]).max() <= _mesh_tol(ref[key]), key
    np.testing.assert_array_equal(np.isnan(got["head_angles"]),
                                  np.isnan(ref["head_angles"]))
    assert np.nanmax(np.abs(got["head_angles"] - ref["head_angles"])) <= 0.1


@pytest.mark.parametrize("face_slab", [None, 2])
def test_full_program_matches_jax(setup, face_slab):
    """Direct (the whole 4-face slab) and speculative (a 2-face prefix of
    frames with more detections: det_count reports the overflow)."""
    frames, models, jmodels = setup
    prog = build_pipeline_program(models, H, W, FaceDetectionMode.FULL,
                                  max_faces=MAX_FACES, face_slab=face_slab)
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in prog(torch.from_numpy(frames)).items()}
    ref = _jax_full(jmodels, frames, face_slab=face_slab)
    d = face_slab or MAX_FACES
    assert got["iris"].shape == (B, d, 152, 3)
    assert got["blendshapes"].shape == (B, d, 52)
    assert got["head_angles"].shape == (B, d, 3)
    assert got["valid"].any(axis=1).all()
    if face_slab:
        assert (got["det_count"] > face_slab).any()
    _assert_full_match(got, ref)
    # The refined eye keypoints are iris points, and the others unchanged.
    v = got["valid"]
    np.testing.assert_array_equal(got["keypoints"][:, :, 2:],
                                  got["raw_keypoints"][:, :, 2:])
    left = got["iris"][:, :, 71:76, :2] / [W, H]
    assert (np.abs(left - got["keypoints"][:, :, None, 0]).sum(-1)
            .min(-1) <= 1e-6)[v].all()


def test_iris_seed_is_not_marginal(setup):
    """The iris point nearest its centroid wins by more than 1e-3 px^2 for
    every face of the setup, so an ulp of difference between the
    packages cannot move a refined eye keypoint by a whole point."""
    frames, models, _ = setup
    prog = build_pipeline_program(models, H, W, FaceDetectionMode.FULL,
                                  max_faces=MAX_FACES)
    with torch.inference_mode():
        out = prog(torch.from_numpy(frames))
    for sl in (slice(71, 76), slice(147, 152)):
        pts = out["iris"][..., sl, :2].double()
        d = ((pts - pts.mean(-2, keepdim=True)) ** 2).sum(-1)
        two = torch.sort(d, dim=-1).values[..., :2]
        gap = (two[..., 1] - two[..., 0])[out["valid"]]
        assert gap.min().item() > 1e-3


def _nan_blendshape_ir(threshold: float) -> ModelIR:
    """[1, 146, 2] -> [1, 52]: RSQRT of a FULLY_CONNECTED whose first
    output is mean(x) - threshold (NaN for a face left of the threshold)
    and whose other outputs are positive."""
    w = np.zeros((52, 292), np.float32)
    w[0, 0::2] = 1.0 / 146
    w[1:] = _rng.uniform(0.0, 0.01, (51, 292))
    b = np.zeros(52, np.float32)
    b[0] = -threshold
    tensors = [TensorIR(0, "x", (1, 146, 2), np.float32, None),
               TensorIR(1, "shape", (2,), np.int32,
                        np.asarray([1, 292], np.int32)),
               TensorIR(2, "flat", (1, 292), np.float32, None),
               TensorIR(3, "w", w.shape, np.float32, w),
               TensorIR(4, "b", b.shape, np.float32, b),
               TensorIR(5, "fc", (1, 52), np.float32, None),
               TensorIR(6, "y", (1, 52), np.float32, None)]
    ops = [OpIR("RESHAPE", [0, 1], [2], {"new_shape": [1, 292]}),
           OpIR("FULLY_CONNECTED", [2, 3, 4], [5],
                {"activation": None, "keep_num_dims": False}),
           OpIR("RSQRT", [5], [6], {})]
    return ModelIR(tensors, ops, [0], [6], "NaN blendshapes")


def test_blendshape_nan_is_sanitized(setup):
    """A blendshape graph that emits NaN for some faces: those faces lose
    blendshapes_valid, NaN becomes 0 and every coefficient is clamped to
    [0, 1], as in the JAX program; the detector then leaves their
    blendshapes out."""
    frames, models, jmodels = setup
    with torch.inference_mode():
        out = build_pipeline_program(models, H, W, FaceDetectionMode.FULL,
                                     max_faces=MAX_FACES)(
            torch.from_numpy(frames))
        packed = pack_blendshape_input(out["mesh"], out["iris"])
    mean_x = np.sort(packed[..., 0].mean(-1)[out["valid"]].numpy())
    mid = len(mean_x) // 2
    threshold = float(mean_x[mid - 1] + mean_x[mid]) / 2
    ir = _nan_blendshape_ir(threshold)
    nan_models = PipelineModels(models.detector, "back", mesh=models.mesh,
                                device="cpu", iris=models.iris,
                                blendshapes=convert_model(ir))
    j_nan = j_programs.PipelineModels(
        jmodels.detector, "back", mesh=jmodels.mesh, iris=jmodels.iris,
        blendshapes=j_convert(jax_ir(ir)))
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in build_pipeline_program(
            nan_models, H, W, FaceDetectionMode.FULL,
            max_faces=MAX_FACES)(torch.from_numpy(frames)).items()}
    ref = _jax_full(j_nan, frames)
    _assert_full_match(got, ref)
    v, ok = got["valid"], got["blendshapes_valid"]
    assert (v & ~ok).any() and ok.any()
    assert (got["blendshapes"][v & ~ok][:, 0] == 0).all()
    assert ((got["blendshapes"] >= 0) & (got["blendshapes"] <= 1)).all()
    det = FaceDetector(models=nan_models, device="cpu", max_faces=MAX_FACES,
                       min_face_presence_confidence=0.0, adaptive=False)
    faces = det.detect_faces_batch(frames)
    assert [f.blendshapes is None for per in faces for f in per] == \
        [not o for i in range(B) for o in ok[i][v[i]]]


def test_detector_full_matches_jax_slab(setup):
    """FaceDetector in FULL (its default mode; speculative dispatch with
    the overflow re-run, int16 readback of mesh and iris) materializes the
    JAX slab's FULL faces."""
    frames, models, jmodels = setup
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES)
    ref = _jax_full(jmodels, frames, min_score=0.5)
    for _ in range(2):  # the first call overflows the 1-face bucket
        faces = det.detect_faces_batch(frames)
    for i in range(B):
        keep = np.flatnonzero(ref["valid"][i]
                              & (ref["mesh_scores"][i] >= 0.5))
        assert len(faces[i]) == len(keep) >= 1
        for face, d in zip(faces[i], keep):
            assert np.abs(face.detection_data.keypoints_xy
                          - ref["keypoints"][i, d]).max() <= 1e-4
            assert face.iris_points.shape == (152, 3)
            assert np.abs(face.iris_points - ref["iris"][i, d]).max() <= \
                _mesh_tol(ref["iris"])
            assert bool(ref["blendshapes_valid"][i, d])
            assert np.abs(face.blendshapes.scores
                          - ref["blendshapes"][i, d]).max() <= 1e-4
            a = face.head_euler_angles
            assert np.abs(np.asarray([a.x, a.y, a.z])
                          - ref["head_angles"][i, d]).max() <= 0.1
