"""The port's standalone model classes against the JAX package's, on the
seeded networks of ``torch_parity.small_pipeline()`` on the CPU.

The JAX classes load their network from a model directory; the tests
hand them the seeded networks by replacing the JAX module's
``convert_file`` and ``_resolve`` for the test's duration (monkeypatch),
so no JAX file changes.  Tolerances: detections equal in count, boxes and
keypoints within 1e-5, scores within 1e-6; the crop networks' outputs
within 1e-5 of their largest magnitude (the executor's parity budget is
2e-6 relative a network), presence scores within 1e-6."""

import numpy as np
import pytest
import torch

from face_detection_tflite_torch import (FaceBlendshapesModel, FaceDetection,
                                         FaceLandmark, IrisLandmark)
from face_detection_tflite_torch.pipeline.config import \
    FaceDetectionModel as Variant
from face_detection_tflite_tpu.models import standalone as j_standalone
from face_detection_tflite_tpu.pipeline.config import (
    MODEL_FILES, FaceDetectionModel as JVariant)

from .torch_parity import rel_err, small_pipeline


@pytest.fixture(scope="module")
def setup():
    return small_pipeline()


@pytest.fixture
def jax_classes(setup, monkeypatch):
    """The JAX module, loading the seeded JAX networks by file name."""
    _, _, jmodels = setup
    by_file = {MODEL_FILES["back"]: jmodels.detector,
               MODEL_FILES["face_landmark"]: jmodels.mesh,
               MODEL_FILES["iris_landmark"]: jmodels.iris,
               MODEL_FILES["face_blendshapes"]: jmodels.blendshapes}
    monkeypatch.setattr(j_standalone, "_resolve", lambda name, _dir: name)
    monkeypatch.setattr(j_standalone, "convert_file",
                        lambda name, precision: by_file[name])
    return j_standalone


def _assert_same_detections(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gb, wb = g.bounding_box, w.bounding_box
        assert np.abs(np.subtract([gb.xmin, gb.ymin, gb.xmax, gb.ymax],
                                  [wb.xmin, wb.ymin, wb.xmax, wb.ymax])
                      ).max() <= 1e-5
        assert np.abs(g.keypoints_xy - np.asarray(w.keypoints_xy)
                      ).max() <= 1e-5
        assert abs(g.score - w.score) <= 1e-6


@pytest.mark.parametrize("max_dim", [None, 144])
def test_face_detection_matches_jax(setup, jax_classes, max_dim):
    """RGB, RGBA and grayscale input, with and without ``max_dim``.  With
    ``max_dim`` the frames come in at twice their size (each pixel
    repeated), so the downscale gives back the frames the detector was
    calibrated on."""
    frames, models, _ = setup
    port = FaceDetection(model=models.detector, device="cpu",
                         max_detections=8, max_dim=max_dim)
    ref = jax_classes.FaceDetection(JVariant.BACK_CAMERA, max_detections=8,
                                    max_dim=max_dim)
    if max_dim is not None:
        frames = frames.repeat(2, axis=1).repeat(2, axis=2)
    for img in frames:
        rgba = np.dstack([img, np.full(img.shape[:2], 9, np.uint8)])
        gray = img.mean(axis=-1).astype(np.uint8)
        assert port(img)
        for x in (img, rgba, gray, np.ascontiguousarray(img[::-1])):
            _assert_same_detections(port(x), ref(x))


def test_face_landmark_matches_jax(setup, jax_classes):
    frames, models, _ = setup
    port = FaceLandmark(model=models.mesh, device="cpu")
    ref = jax_classes.FaceLandmark()
    import cv2
    for img in frames:
        crop = cv2.resize(img[:, :96], (192, 192),
                          interpolation=cv2.INTER_LINEAR)
        lm, score = port.call_with_score(crop)
        want_lm, want_score = ref.call_with_score(crop)
        assert lm.shape == (468, 3) and lm.dtype == np.float32
        assert rel_err(lm, want_lm) <= 1e-5
        assert abs(score - want_score) <= 1e-6
        assert np.array_equal(port(crop), lm)


def test_iris_landmark_matches_jax(setup, jax_classes):
    frames, models, _ = setup
    port = IrisLandmark(model=models.iris, device="cpu")
    ref = jax_classes.IrisLandmark()
    for img in frames:
        for crop in (img[:64, :64], img[-64:, -64:]):
            got, want = port(crop), np.asarray(ref(crop))
            assert got.shape == (76, 3)
            assert rel_err(got, want) <= 1e-5


def test_blendshapes_model_matches_jax(setup, jax_classes):
    """Coefficients within 1e-5, and ``None`` where the network emits a
    NaN (a NaN in the input)."""
    _, models, _ = setup
    port = FaceBlendshapesModel(model=models.blendshapes, device="cpu")
    ref = jax_classes.FaceBlendshapesModel()
    rng = np.random.default_rng(0)
    for _ in range(3):
        pts = rng.uniform(0, 500, (146, 2))
        got, want = port(pts), np.asarray(ref(pts))
        assert got.shape == (52,) and (got >= 0).all() and (got <= 1).all()
        assert np.abs(got - want).max() <= 1e-5
    pts[17, 1] = np.nan
    assert port(pts) is None and ref(pts) is None


def test_standalone_input_contracts(setup):
    """The ValueErrors of the JAX package's ``TestStandaloneInputContracts``
    on wrong shapes, dispose poisoning (``TestDispose``), the unported
    variants and precisions, and no silent CPU: without CUDA a class needs
    ``device="cpu"``."""
    _, models, _ = setup
    det = FaceDetection(model=models.detector, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        det(np.zeros((64, 64, 7), np.uint8))
    lm = FaceLandmark(model=models.mesh, device="cpu")
    with pytest.raises(ValueError, match="192x192"):
        lm.call_with_score(np.zeros((100, 100, 3), np.uint8))
    iris = IrisLandmark(model=models.iris, device="cpu")
    with pytest.raises(ValueError, match="64x64"):
        iris(np.zeros((32, 32, 3), np.uint8))
    bs = FaceBlendshapesModel(model=models.blendshapes, device="cpu")
    with pytest.raises(ValueError, match="146, 2"):
        bs(np.zeros((100, 2)))
    for m, arg in ((det, np.zeros((64, 64, 3), np.uint8)),
                   (lm, np.zeros((192, 192, 3), np.uint8)),
                   (iris, np.zeros((64, 64, 3), np.uint8)),
                   (bs, np.zeros((146, 2), np.float32))):
        m.dispose()
        with pytest.raises(RuntimeError, match="disposed"):
            m(arg)
    # Every variant is ported; a network whose anchors are not the
    # variant's is refused.
    with pytest.raises(ValueError, match="anchors"):
        FaceDetection(Variant.FULL, model=models.detector, device="cpu")
    # The tiers are ported: a class runs its network at its precision; a
    # name that is not a tier is refused.
    assert set(IrisLandmark(model=models.iris, device="cpu",
                            precision="default").model.tiers) <= {
        "default", None}
    with pytest.raises(ValueError, match="precision"):
        IrisLandmark(model=models.iris, device="cpu", precision="bf16x3")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FaceLandmark(model=models.mesh)
