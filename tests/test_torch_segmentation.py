"""Selfie segmentation against the JAX package on the same seeded
segmenter IRs, on the CPU.

The general (256x256), landscape (144x256) and multiclass (256x256, six
classes) segmenters run at narrow widths (``torch_parity.SMALL_SEGMENTER``,
every op kind of the published ones), the binary ones also at their
published widths.  Tolerances: mask planes (the person plane and the six
class planes) within 1e-5 absolute; uint8 masks equal, except where the
float plane lies within 1e-4 of a .5 tie of ``p * 255`` (the counts are
printed: on these seeds 0 of 28 such values differ for general, 0 of 19
for landscape, 4 of 172 for multiclass); mask methods on the
same arrays equal to the JAX package's (``upsample`` within 1e-6).  The
detector's segmentation surface, ``ServingPipeline(with_segmentation=True)``
and the two server routes hold the same masks; faces there within the
tolerances of ``tests/test_torch_serving.py``."""

import base64
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                         FaceServer, SegmentationConfig,
                                         SegmentationModel, ServingPipeline)
from face_detection_tflite_torch.convert.executor import convert_model
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.models import segmentation as t_seg
from face_detection_tflite_torch.utils.camera import (
    CameraRotation, camera_frame_from_image, decode_camera_frame)
from face_detection_tflite_tpu.models import segmentation as j_seg
from face_detection_tflite_tpu.pipeline import detector as j_detector
from face_detection_tflite_tpu.pipeline import server as j_server
from face_detection_tflite_tpu.pipeline.config import (
    MODEL_FILES, SegmentationModel as JSegModel)

from .torch_parity import B, MAX_FACES, W, both_models, small_pipeline

KINDS = ["general", "landscape", "multiclass"]
_SETUPS: dict = {}


def _setup(kind):
    """(frames, port models carrying the segmenter, JAX models, JAX
    segmenter) of the small pipeline with the narrow ``kind`` segmenter."""
    if kind not in _SETUPS:
        _SETUPS[kind] = small_pipeline("back", segmenter=kind)
    return _SETUPS[kind]


def _png(img) -> bytes:
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _ties(plane: np.ndarray) -> np.ndarray:
    """Where ``p * 255`` of a [0, 1]-clipped plane is within 1e-4 of k + .5."""
    v = np.clip(plane, 0.0, 1.0) * 255.0
    return np.abs(v - np.floor(v) - 0.5) < 1e-4


def _assert_masks_match(got, want, uint8=False):
    """Mask objects of the two packages: same geometry, planes within
    1e-5 (uint8: equal away from .5 ties)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.width, g.height, g.original_width, g.original_height) == \
            (w.width, w.height, w.original_width, w.original_height)
        assert g.padding == w.padding
        assert g.default_max_size == w.default_max_size
        pairs = [(g.data, w.data)]
        if isinstance(w, j_seg.MulticlassSegmentationMask):
            assert isinstance(g, t_seg.MulticlassSegmentationMask)
            pairs.append((g.class_data, w.class_data))
        for a, b in pairs:
            assert a.shape == b.shape and a.dtype == b.dtype
            err = np.abs(a - b)
            if uint8:
                assert np.allclose(err[err > 0], 1 / 255)
            else:
                assert err.max() <= 1e-5


@pytest.mark.parametrize("mask_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("kind", KINDS)
def test_segmenter_matches_jax(kind, mask_dtype):
    frames, models, _, jseg = _setup(kind)
    multiclass = kind == "multiclass"
    port = t_seg.SelfieSegmentation(models.segmentation, multiclass,
                                    mask_dtype=mask_dtype, device="cpu")
    ref = j_seg.SelfieSegmentation(jseg, multiclass, mask_dtype=mask_dtype)
    got, want = port(frames), ref(frames)
    assert got[0].data.shape == ((144, 256) if kind == "landscape"
                                 else (256, 256))
    if mask_dtype == "float32":
        _assert_masks_match(got, want)
        return
    # uint8: equal except at .5 ties of the float planes.
    floats = t_seg.SelfieSegmentation(models.segmentation, multiclass,
                                      device="cpu")(frames)
    differ = ties = 0
    for g, w, f in zip(got, want, floats):
        for a, b, p in ((g.data, w.data, f.data),) + (
                ((g.class_data, w.class_data, f.class_data),)
                if multiclass else ()):
            neq = a != b
            differ += int(neq.sum())
            ties += int(_ties(p).sum())
            assert not (neq & ~_ties(p)).any()
    print(f"{kind} uint8: {differ} values differ, {ties} .5 ties")
    _assert_masks_match(got, want, uint8=True)


@pytest.mark.parametrize("landscape", [False, True])
def test_published_width_segmenters_match_jax(landscape):
    """The binary segmenters at their published widths (119,413 fp16
    weights), one frame each."""
    ir = random_init.selfie_segmenter_ir(7, landscape=landscape)
    jm, tm = both_models(ir)
    assert tm.num_params == 119_413
    frame = np.random.default_rng(7).integers(0, 256, (1, 200, 300, 3),
                                              dtype=np.uint8)
    got = t_seg.SelfieSegmentation(tm, device="cpu")(frame)
    want = j_seg.SelfieSegmentation(jm)(frame)
    _assert_masks_match(got, want)


def test_published_multiclass_size():
    m = convert_model(random_init.selfie_multiclass_ir(0))
    assert m.num_params == 8_168_956
    assert m.input_shapes[0] == (1, 256, 256, 3)
    assert [tuple(s) for s in m.output_shapes] == [(1, 256, 256, 6)]
    ops = {op.name for op in m._ops}
    assert {"HARD_SWISH", "AVERAGE_POOL_2D", "RESIZE_BILINEAR", "MUL",
            "CUSTOM:Convolution2DTransposeBias", "LOGISTIC"} <= ops


@pytest.mark.parametrize("size", [(96, 144), (300, 200), (101, 257)])
@pytest.mark.parametrize("dst", [(256, 256), (144, 256)])
def test_geometry_matches_jax(size, dst):
    """``mask_valid_region`` and ``crop_valid_and_resize`` on the letterbox
    padding of square and landscape segmenter inputs (dst_h != dst_w)."""
    from face_detection_tflite_torch.ops.letterbox import letterbox_params
    pad = letterbox_params(*size, *dst).padding
    assert t_seg.mask_valid_region(dst[1], dst[0], pad) == \
        j_seg.mask_valid_region(dst[1], dst[0], pad)
    plane = np.random.default_rng(1).uniform(0, 1, dst).astype(np.float32)
    for out in ((size[1], size[0]), (77, 51)):
        np.testing.assert_array_equal(
            t_seg.crop_valid_and_resize(plane, dst[1], dst[0], pad, *out),
            j_seg.crop_valid_and_resize(plane, dst[1], dst[0], pad, *out))
    np.testing.assert_array_equal(t_seg.corner_resize_matrix(37, 90),
                                  j_seg.corner_resize_matrix(37, 90))
    assert t_seg._dart_round(1500.5) == j_seg._dart_round(1500.5) == 1501


@pytest.mark.parametrize("multiclass", [False, True])
def test_mask_methods_match_jax(multiclass):
    """Each package's mask object built on the same arrays: upsample,
    confidence_at, to_uint8, to_binary, to_rgba, the class masks and the
    serialize / deserialize round trip in every format."""
    rng = np.random.default_rng(3)
    data = rng.uniform(0, 1, (144, 256)).astype(np.float32)
    args = (data, 640, 360, (0.05, 0.07, 0.0, 0.0))
    if multiclass:
        cls = rng.dirichlet(np.ones(6), (144, 256)).astype(np.float32)
        got = t_seg.MulticlassSegmentationMask(*args, class_data=cls,
                                               default_max_size=500)
        want = j_seg.MulticlassSegmentationMask(*args, class_data=cls,
                                                default_max_size=500)
        for c in t_seg.SegmentationClass:
            np.testing.assert_array_equal(got.class_mask(c),
                                          want.class_mask(int(c)))
        np.testing.assert_array_equal(got.hair_mask, want.hair_mask)
    else:
        got = t_seg.SegmentationMask(*args, default_max_size=500)
        want = j_seg.SegmentationMask(*args, default_max_size=500)
    for kw in ({}, {"max_size": 0}, {"target_width": 99, "target_height": 57},
               {"max_size": 300}):
        u, v = got.upsample(**kw), want.upsample(**kw)
        assert u.data.shape == v.data.shape
        assert np.abs(u.data - v.data).max() <= 1e-6
    assert got.confidence_at(0.3, 0.8) == want.confidence_at(0.3, 0.8)
    np.testing.assert_array_equal(got.to_uint8(), want.to_uint8())
    np.testing.assert_array_equal(got.to_binary(0.4), want.to_binary(0.4))
    np.testing.assert_array_equal(got.to_rgba((1, 2, 3, 4)),
                                  want.to_rgba((1, 2, 3, 4)))
    for fmt in ("float32", "uint8", "binary"):
        d = got.serialize(fmt)
        assert d == want.serialize(fmt)
        back = t_seg.SegmentationMask.deserialize(d)
        ref = j_seg.SegmentationMask.deserialize(d)
        assert type(back).__name__ == type(ref).__name__
        np.testing.assert_array_equal(back.data, ref.data)
        if fmt == "float32":
            np.testing.assert_array_equal(back.data, got.data)
    with pytest.raises(ValueError, match="format"):
        got.serialize("png")


def test_min_size_and_dtype_errors():
    _, models, _, _ = _setup("general")
    seg = t_seg.SelfieSegmentation(models.segmentation, device="cpu")
    with pytest.raises(ValueError, match="minimum"):
        seg(np.zeros((1, 15, 40, 3), np.uint8))
    seg(np.zeros((1, 16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="mask_dtype"):
        t_seg.SelfieSegmentation(models.segmentation, mask_dtype="int8",
                                 device="cpu")
    seg.place_on("cpu")       # its own device: nothing moves
    assert seg.device.type == "cpu" and seg.model is models.segmentation
    seg.dispose()
    with pytest.raises(RuntimeError, match="disposed"):
        seg.place_on("cpu")
    with pytest.raises(RuntimeError, match="disposed"):
        seg(np.zeros((1, 32, 32, 3), np.uint8))


def test_channel_check_and_precision():
    """6 channels for MULTICLASS and 1 otherwise (ValueError); every
    preset loads, and the segmenter runs at its config's precision (the
    default "high", the safe preset's "highest")."""
    _, general, _, _ = _setup("general")
    _, multi, _, _ = _setup("multiclass")
    for models, seg_model in ((general, SegmentationModel.MULTICLASS),
                              (multi, SegmentationModel.GENERAL)):
        with pytest.raises(ValueError, match="channels"):
            FaceDetector(models=models, device="cpu", with_segmentation=True,
                         segmentation_model=seg_model)
    FaceDetector(models=general, device="cpu", segmentation_config=(
        SegmentationConfig(model=SegmentationModel.MULTICLASS,
                           precision="highest", validate_model=False)))
    for cfg in (SegmentationConfig(), SegmentationConfig.performance(),
                SegmentationConfig.fast()):
        det = FaceDetector(models=general, device="cpu",
                           segmentation_config=cfg)
        assert det.is_segmentation_ready
        assert set(det._segmentation.model.tiers) <= {"high", None}
    det = FaceDetector(models=general, device="cpu",
                       segmentation_config=SegmentationConfig.safe())
    assert det.is_segmentation_ready
    assert det._segmentation.max_output_size == 1024
    with pytest.raises(ValueError, match="mask_dtype"):
        SegmentationConfig(mask_dtype="int8")


def test_detector_segmentation_surface(tmp_path):
    """Masks through every detector entry point equal the segmenter's
    own; the combined calls' faces equal ``detect_faces``'; one upload
    serves a detection and a mask of the same frame; lazy load,
    ``initialize_segmentation`` and ``dispose``."""
    frames, models, _, _ = _setup("general")
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES)
    assert not det.is_segmentation_ready
    seg = t_seg.SelfieSegmentation(models.segmentation, device="cpu")
    img = frames[0]
    want = seg(img[None])[0]
    faces = det.detect_faces(img)
    uploaded = det._devput_cache[2]
    mask = det.get_segmentation_mask(img)   # lazy load
    assert det.is_segmentation_ready
    assert det._devput_cache[2] is uploaded
    assert det.accelerator_report["segmentation"] == "cpu"
    assert det.memory_report()["segmentation"] == sum(
        t.numel() * 4 for t in models.segmentation.state_dict().values()) + \
        sum(b.numel() * b.element_size()
            for n, b in models.segmentation.named_buffers()
            if n not in models.segmentation.state_dict())
    _assert_same(mask, want)
    path = tmp_path / "frame.png"
    path.write_bytes(_png(img))
    _assert_same(det.get_segmentation_mask_from_bytes(_png(img)), want)
    _assert_same(det.get_segmentation_mask_from_filepath(str(path)), want)
    frame = camera_frame_from_image(img, CameraRotation.CW90)
    decoded = decode_camera_frame(frame)
    cam_want = seg(decoded[None])[0]
    _assert_same(det.get_segmentation_mask_from_camera_frame(frame),
                 cam_want)
    for got_faces, got_mask, ref_faces, ref_mask in (
            (*det.detect_faces_with_segmentation(img), faces, want),
            (*det.detect_faces_with_segmentation_from_bytes(_png(img)),
             faces, want),
            (*det.detect_faces_with_segmentation_from_camera_frame(frame),
             det.detect_faces(decoded), cam_want)):
        assert [f.to_dict(include_mesh=True) for f in got_faces] == \
            [f.to_dict(include_mesh=True) for f in ref_faces]
        _assert_same(got_mask, ref_mask)
    det.initialize_segmentation()   # loaded: a no-op
    with pytest.warns(UserWarning, match="already"):
        det.initialize_segmentation(SegmentationConfig.safe())
    det.dispose()
    assert not det.is_segmentation_ready
    fresh = FaceDetector(models=models, device="cpu")
    fresh.initialize_segmentation(SegmentationConfig.safe())
    assert fresh.is_segmentation_ready


def _assert_same(got, want):
    assert got.padding == want.padding
    np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("kind", ["landscape", "multiclass"])
def test_combined_batch_matches_separate_calls(kind):
    """``detect_faces_with_segmentation_batch`` against
    ``detect_faces_batch`` and the segmenter run apart; the tracking IDs
    of the single-image combined call."""
    frames, models, _, _ = _setup(kind)
    seg_model = SegmentationModel(kind)
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                       segmentation_model=seg_model, with_segmentation=True,
                       enable_tracking=True)
    pairs = det.detect_faces_with_segmentation_batch(frames)
    faces = det.detect_faces_batch(frames)
    masks = t_seg.SelfieSegmentation(models.segmentation,
                                     kind == "multiclass",
                                     device="cpu")(frames)
    assert len(pairs) == B
    for (f, m), f2, m2 in zip(pairs, faces, masks):
        assert [x.to_dict(include_mesh=True) for x in f] == \
            [x.to_dict(include_mesh=True) for x in f2]
        assert type(m) is type(m2)
        _assert_same(m, m2)
        if kind == "multiclass":
            np.testing.assert_array_equal(m.class_data, m2.class_data)
    tracked, _ = det.detect_faces_with_segmentation(frames[0])
    assert [f.tracking_id for f in tracked] == list(range(1, len(tracked) + 1))


def test_serving_pipeline_with_segmentation():
    frames, models, _, _ = _setup("general")
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES)
    with ServingPipeline(det, FaceDetectionMode.FULL,
                         with_segmentation=True) as pipe:
        futures = [pipe.submit(frames), pipe.submit(frames[::-1])]
        results = [f.result(timeout=300) for f in futures]
    want = det.detect_faces_with_segmentation_batch(frames)
    for result, order in zip(results, (slice(None), slice(None, None, -1))):
        for (f, m), (wf, wm) in zip(result, want[order]):
            assert [x.to_dict(include_mesh=True) for x in f] == \
                [x.to_dict(include_mesh=True) for x in wf]
            _assert_same(m, wm)


def _post(url, body, timeout=300):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _jax_detector(monkeypatch, tmp_path, jmodels, jseg):
    """The JAX FaceDetector on the seeded JAX networks: placeholder files
    in a model directory, ``convert_file`` returning the networks by
    name."""
    monkeypatch.setenv("FDT_NO_COMPILE_CACHE", "1")
    by_file = {MODEL_FILES["back"]: jmodels.detector,
               MODEL_FILES["face_landmark"]: jmodels.mesh,
               MODEL_FILES["iris_landmark"]: jmodels.iris,
               MODEL_FILES["face_blendshapes"]: jmodels.blendshapes,
               MODEL_FILES["segmenter_general"]: jseg}
    for name in by_file:
        (tmp_path / name).write_bytes(b"")
    monkeypatch.setattr(j_detector, "convert_file",
                        lambda path, precision="highest":
                        by_file[os.path.basename(path)])
    return j_detector.FaceDetector(model_dir=str(tmp_path),
                                   max_faces=MAX_FACES, adaptive=False,
                                   with_segmentation=True,
                                   segmentation_model=JSegModel.GENERAL,
                                   precision="highest")


def _mask_bytes(payload):
    return base64.b64decode(payload["data_b64"])


def test_server_segment_routes_match_jax(monkeypatch, tmp_path):
    """``/v1/segment`` (each format, and upsampled) and
    ``/v1/detect_with_segmentation`` answer 200 with the JAX server's JSON:
    the same mask fields, uint8 and binary bytes equal away from ties,
    float32 within 1e-5, faces within the serving tolerances."""
    frames, models, jmodels, jseg = _setup("general")
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                       with_segmentation=True)
    jdet = _jax_detector(monkeypatch, tmp_path, jmodels, jseg)
    body = _png(frames[1])
    port = FaceServer(det, batch_window_ms=5.0).start()
    ref = j_server.FaceServer(jdet, batch_window_ms=5.0).start()
    try:
        with urllib.request.urlopen(f"{port.address}/v1/info",
                                    timeout=60) as r:
            assert json.loads(r.read())["segmentation_ready"] is True
        for query in ("", "?format=float32", "?format=binary",
                      "?format=uint8&upsample=1"):
            got_status, got = _post(f"{port.address}/v1/segment{query}",
                                    body)
            want_status, want = _post(f"{ref.address}/v1/segment{query}",
                                      body)
            assert got_status == want_status == 200
            _assert_payloads_match(got["mask"], want["mask"])
        got_status, got = _post(
            f"{port.address}/v1/detect_with_segmentation?mesh=1", body)
        want_status, want = _post(
            f"{ref.address}/v1/detect_with_segmentation?mesh=1", body)
        assert got_status == want_status == 200
        assert got["mode"] == want["mode"] == "standard"
        _assert_payloads_match(got["mask"], want["mask"])
        assert len(got["faces"]) == len(want["faces"]) >= 1
        for g, w in zip(got["faces"], want["faces"]):
            for k in ("xmin", "ymin", "xmax", "ymax"):
                assert abs(g["bounding_box"][k] - w["bounding_box"][k]) \
                    <= 1e-4
            assert np.abs(np.asarray(g["mesh"]) - np.asarray(w["mesh"])
                          ).max() <= 2.0 * W / 32000.0 + 1e-3
        status, err = _post(f"{port.address}/v1/segment?format=png", body)
        assert status == 400 and "format" in err["error"]
    finally:
        port.close()
        ref.close()


def _assert_payloads_match(got, want):
    assert set(got) == set(want)
    for k in got:
        if k not in ("data_b64", "class_data_b64"):
            assert got[k] == want[k], k
    a, b = _mask_bytes(got), _mask_bytes(want)
    if got["data_format"] == "float32":
        fa, fb = (np.frombuffer(x, np.float32) for x in (a, b))
        assert np.abs(fa - fb).max() <= 1e-5
    else:
        ua, ub = (np.frombuffer(x, np.uint8) for x in (a, b))
        assert (ua != ub).sum() == 0
