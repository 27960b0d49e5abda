"""The port's video and camera path on the CPU against the JAX package:
the temporal tracker, the two landmark smoothers, the camera-frame decode,
``FrameThrottle``, ``process_video`` and the tracking surface of
``FaceDetector``.

Tolerances: the tracker's IDs are equal on every frame; the smoothers'
outputs and the camera decode are equal bit for bit, since both packages
run the same float64 (smoothers) or uint8/float32 (decode) numpy code on
the same arrays; ``process_video`` yields the same frames, timestamps and
batches as the JAX function with the same stub detector."""

import threading

import numpy as np
import pytest
import torch

from face_detection_tflite_torch import FaceDetector
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.pipeline import smoothing as t_smoothing
from face_detection_tflite_torch.pipeline import tracker as t_tracker
from face_detection_tflite_torch.pipeline import types as t_types
from face_detection_tflite_torch.pipeline import video as t_video
from face_detection_tflite_torch.utils import camera as t_camera
from face_detection_tflite_torch.utils import image as t_image
from face_detection_tflite_tpu.pipeline import smoothing as j_smoothing
from face_detection_tflite_tpu.pipeline import tracker as j_tracker
from face_detection_tflite_tpu.pipeline import types as j_types
from face_detection_tflite_tpu.pipeline import video as j_video
from face_detection_tflite_tpu.utils import camera as j_camera
from face_detection_tflite_tpu.utils import image as j_image

from . import torch_parity  # noqa: F401 (one thread per xdist worker)

cv2 = pytest.importorskip("cv2")

# -- tracker ----------------------------------------------------------------

_INVALID_BOXES = ([float("nan"), 0.1, 0.3, 0.3], [0.3, 0.3, 0.3, 0.5],
                  [0.5, 0.5, 0.4, 0.6], [float("inf"), 0.2, 0.4, 0.4])


def _box_sequence(seed: int, kind: str) -> tuple[int, list]:
    """(max_missed_frames, 30 frames of float32 boxes) of a seeded scene:
    faces moving at constant velocity with jitter; ``kind`` adds vanishing
    and reappearing faces, scale jumps, invalid boxes, duplicated boxes
    (candidates of equal score, decided by detection index), faces that
    appear from nowhere, or all of them (``mixed``)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    pos = rng.uniform(0.05, 0.7, (n, 2))
    size = rng.uniform(0.05, 0.3, n)
    vel = rng.normal(0, 0.015, (n, 2))
    mixed = kind == "mixed"
    frames = []
    for t in range(30):
        boxes = []
        for k in range(n):
            if (kind == "vanish" or mixed) and rng.uniform() < 0.3:
                continue
            s = size[k]
            if (kind == "scale" or mixed) and rng.uniform() < 0.2:
                s *= rng.choice([0.3, 0.45, 2.2, 4.0])
            p = pos[k] + vel[k] * t + rng.normal(0, 0.004, 2)
            boxes.append([p[0], p[1], p[0] + s, p[1] + s])
        if (kind == "appear" or mixed) and rng.uniform() < 0.3:
            p = rng.uniform(0, 0.8, 2)
            s = rng.uniform(0.05, 0.3)
            boxes.append([p[0], p[1], p[0] + s, p[1] + s])
        if (kind == "invalid" or mixed) and rng.uniform() < 0.3:
            boxes.append(list(_INVALID_BOXES[rng.integers(4)]))
        if (kind == "ties" or mixed) and boxes and rng.uniform() < 0.4:
            boxes.append(list(boxes[rng.integers(len(boxes))]))
        order = rng.permutation(len(boxes))
        frames.append([list(np.float32(boxes[i])) for i in order])
    return int(rng.integers(0, 5)), frames


def _ids_both(max_missed: int, frames) -> tuple[list, list]:
    port = t_tracker.TemporalFaceTracker(max_missed_frames=max_missed)
    ref = j_tracker.TemporalFaceTracker(max_missed_frames=max_missed)
    return [port.update(b) for b in frames], [ref.update(b) for b in frames]


@pytest.mark.parametrize("kind", ["moving", "vanish", "scale", "appear",
                                  "invalid", "ties", "mixed"])
def test_tracker_ids_match_jax_on_seeded_sequences(kind):
    """Ten seeded 30-frame sequences a kind: the IDs are equal on every
    frame."""
    for seed in range(10):
        max_missed, frames = _box_sequence(1000 * len(kind) + seed, kind)
        got, want = _ids_both(max_missed, frames)
        assert got == want, (kind, seed)


def _b(x, y, s=0.2):
    return [x, y, x + s, y + s]


#: The cases of the JAX package's ``tests/test_shared.py::TestTracker``:
#: (max_missed_frames, frames, the IDs the JAX test asserts of the last
#: frame).
_TRACKER_CASES = {
    "stable ids": (3, [[_b(0.1, 0.1), _b(0.6, 0.6)],
                       [_b(0.11, 0.11), _b(0.61, 0.61)]], [1, 2]),
    "retirement": (1, [[_b(0.1, 0.1)], [], [], [_b(0.1, 0.1)]], [2]),
    "reappearance": (3, [[_b(0.1, 0.1)], [], [_b(0.1, 0.1)]], [1]),
    "velocity": (3, [[_b(0.1, 0.1)], [_b(0.15, 0.1)], [_b(0.2, 0.1)],
                     [_b(0.25, 0.1)]], [1]),
    "scale dissimilarity": (3, [[[0.1, 0.1, 0.2, 0.2]],
                                [[0.0, 0.0, 0.9, 0.9]]], [2]),
    "global score order": (3, [[_b(0.5, 0.5)],
                               [_b(0.8, 0.8), _b(0.5, 0.5)]], [2, 1]),
}


@pytest.mark.parametrize("case", sorted(_TRACKER_CASES))
def test_tracker_cases_of_the_jax_tests(case):
    max_missed, frames, last = _TRACKER_CASES[case]
    got, want = _ids_both(max_missed, frames)
    assert got == want
    assert got[-1] == last


def test_tracker_reset_and_validation():
    for tracker in (t_tracker.TemporalFaceTracker(),
                    j_tracker.TemporalFaceTracker()):
        tracker.update([_b(0.1, 0.1)])
        tracker.reset()
        assert tracker.update([_b(0.1, 0.1)]) == [1]
        assert tracker.active_track_count == 1
    for validate in (t_tracker.validate_tracking_config,
                     j_tracker.validate_tracking_config):
        with pytest.raises(ValueError):
            validate(-1)
    with pytest.raises(ValueError):
        t_tracker.TemporalFaceTracker(max_normalized_center_distance=0.5)
    with pytest.raises(ValueError):
        t_tracker.TemporalFaceTracker(min_scale_similarity=1.5)


# -- smoothers ----------------------------------------------------------------


def _face_arrays(rng, n_frames: int = 14):
    """Per frame, a list of per-face dicts of numpy arrays: two faces
    drifting with jitter (one of them loses its mesh for some frames, one
    of them sometimes has no tracking ID), with empty frames between."""
    base = rng.uniform(0.1, 0.6, (2, 2))
    mesh0 = rng.uniform(100, 500, (2, 468, 3))
    iris0 = rng.uniform(100, 500, (2, 152, 3))
    frames = []
    for t in range(n_frames):
        if t in (4, 9):
            frames.append([])
            continue
        faces = []
        for k in range(2):
            if k == 1 and t == 6:
                continue
            p = base[k] + 0.01 * t + rng.normal(0, 0.003, 2)
            mesh = None if (k == 1 and t in (7, 8)) else \
                mesh0[k] + 3.0 * t + rng.normal(0, 1.5, (468, 3))
            faces.append(dict(
                box=np.float32([p[0], p[1], p[0] + 0.25, p[1] + 0.3]),
                score=float(rng.uniform(0.6, 1.0)),
                kp=(p + rng.uniform(0, 0.25, (6, 2))).astype(np.float32),
                mesh=mesh, mesh_score=float(rng.uniform(0.5, 1.0)),
                iris=(iris0[k] + 3.0 * t + rng.normal(0, 1.0, (152, 3))
                      if mesh is not None else np.zeros((0, 3))),
                bs=rng.uniform(0, 1, 52).astype(np.float32),
                tid=None if (k == 1 and t == 11) else k + 1,
                emb=rng.normal(0, 1, 192).astype(np.float32)))
        frames.append(faces)
    return frames


def _make_face(types, d):
    det = types.Detection(types.RectF(*map(float, d["box"])), d["score"],
                          d["kp"])
    mesh = (types.FaceMesh(d["mesh"], score=d["mesh_score"])
            if d["mesh"] is not None else None)
    return types.Face(detection=det, mesh=mesh, irises=d["iris"],
                      original_size=(640, 480), blendshape_scores=d["bs"],
                      tracking_id=d["tid"], embedding=d["emb"])


def _same_array(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


def _assert_same_face(got, want):
    gb, wb = got.bounding_box, want.bounding_box
    assert (gb.xmin, gb.ymin, gb.xmax, gb.ymax) == \
        (wb.xmin, wb.ymin, wb.xmax, wb.ymax)
    assert got.score == want.score
    assert got.tracking_id == want.tracking_id
    assert _same_array(got.detection_data.keypoints_xy,
                       want.detection_data.keypoints_xy)
    assert _same_array(got.mesh.points if got.mesh else None,
                       want.mesh.points if want.mesh else None)
    assert _same_array(got.iris_points, want.iris_points)
    assert _same_array(got.embedding, want.embedding)
    assert _same_array(got.blendshapes.scores, want.blendshapes.scores)
    ga, wa = got.head_euler_angles, want.head_euler_angles
    assert _same_array([ga.x, ga.y, ga.z], [wa.x, wa.y, wa.z])


@pytest.mark.parametrize("method,timed", [("ema", False), ("one_euro", False),
                                          ("one_euro", True)])
def test_smoother_matches_jax(method, timed):
    """Both smoothers over seeded face sequences (empty frames, mesh-less
    faces, faces without an ID, a face that leaves and comes back),
    built in each package's own types from one set of arrays: every
    output equal bit for bit, the re-derived head pose included."""
    for seed in range(3):
        frames = _face_arrays(np.random.default_rng(seed))
        port = t_smoothing.FaceSmoother(method=method, max_missed_frames=1)
        ref = j_smoothing.FaceSmoother(method=method, max_missed_frames=1)
        for t, faces in enumerate(frames):
            t_sec = 0.04 * t if timed else None
            got = port.smooth([_make_face(t_types, d) for d in faces], t_sec)
            want = ref.smooth([_make_face(j_types, d) for d in faces], t_sec)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _assert_same_face(g, w)


def test_one_euro_filter_matches_jax():
    rng = np.random.default_rng(5)
    port, ref = t_smoothing.OneEuroFilter(), j_smoothing.OneEuroFilter()
    for t in (0.0, 0.03, 0.03, 0.07, 0.2, 0.21):
        x = rng.normal(0, 5, (468, 2))
        assert _same_array(port.filter(x, t), ref.filter(x, t))
    with pytest.raises(ValueError):
        t_smoothing.OneEuroFilter(min_cutoff=0)
    with pytest.raises(ValueError):
        t_smoothing.FaceSmoother(method="kalman")


# -- camera frames ------------------------------------------------------------


def _both_frames(data, w, h, fmt, rotation=0, row_stride=None,
                 chroma_row_stride=None):
    return tuple(cam.CameraFrame(data, w, h, cam.CameraFormat(fmt),
                                 cam.CameraRotation(rotation), row_stride,
                                 chroma_row_stride)
                 for cam in (t_camera, j_camera))


def _frame_bytes(rng, w, h, fmt, row_stride, chroma_row_stride) -> bytes:
    """Seeded bytes of exactly the length the decode reads."""
    cw, ch = (w + 1) // 2, (h + 1) // 2
    if fmt in ("rgba", "bgra"):
        n = (row_stride or 4 * w) * h
    else:
        ys = row_stride or w
        if fmt == "i420":
            cs = chroma_row_stride or ((ys + 1) // 2 if row_stride else cw)
            n = ys * h + 2 * cs * ch
        else:
            cs = chroma_row_stride or (max(ys, 2 * cw) if row_stride
                                       else 2 * cw)
            n = ys * h + cs * ch
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


_SIZES = [(96, 64), (9, 11), (47, 31), (31, 10)]


@pytest.mark.parametrize("fmt", ["i420", "nv12", "nv21", "rgba", "bgra"])
def test_decode_camera_frame_matches_jax(fmt):
    """Every format at even and odd sizes, unpadded and with padded Y (or
    RGBA) rows and padded chroma rows, under all four rotations and with
    and without ``max_dim``: equal bit for bit."""
    rng = np.random.default_rng(len(fmt))
    for w, h in _SIZES:
        bpp = 4 if fmt in ("rgba", "bgra") else 1
        strides = [(None, None), (w * bpp + 64, None)]
        if bpp == 1:
            cw = (w + 1) // 2
            strides.append((w + 16, (2 * cw if fmt != "i420" else cw) + 8))
        for row_stride, chroma in strides:
            data = _frame_bytes(rng, w, h, fmt, row_stride, chroma)
            for rotation in (0, 90, 180, 270):
                for max_dim in (None, max(w, h) // 2 + 1):
                    port, ref = _both_frames(data, w, h, fmt, rotation,
                                             row_stride, chroma)
                    got = t_camera.decode_camera_frame(port, max_dim)
                    want = j_camera.decode_camera_frame(ref, max_dim)
                    assert got.dtype == want.dtype == np.uint8
                    assert got.flags.c_contiguous
                    assert np.array_equal(got, want), \
                        (w, h, row_stride, chroma, rotation, max_dim)


def test_rgb_from_yuv420_and_fit_max_dim_match_jax():
    rng = np.random.default_rng(2)
    for h, w in ((64, 96), (11, 9)):
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        u, v = (rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2),
                             dtype=np.uint8) for _ in range(2))
        assert np.array_equal(t_image.rgb_from_yuv420(y, u, v),
                              j_image.rgb_from_yuv420(y, u, v))
    img = rng.integers(0, 256, (60, 90, 3), dtype=np.uint8)
    for max_dim in (45, 61, 90, 200):
        assert np.array_equal(t_image.fit_max_dim(img, max_dim),
                              j_image.fit_max_dim(img, max_dim))
    assert t_image.fit_max_dim(img, 90) is img


def test_normalize_channels_keeps_the_jax_errors():
    for bad in ((2, 8, 3), (8, 8), (1, 2, 8, 8, 3), (1, 8, 8, 7)):
        with pytest.raises(ValueError):
            j_image.validate_batch_shape(bad)
        with pytest.raises(ValueError):
            t_image.normalize_channels(np.zeros(bad, np.uint8),
                                       torch.device("cpu"))
    rng = np.random.default_rng(0)
    for shape in ((2, 5, 6, 1), (2, 5, 6, 3), (2, 5, 6, 4), (2, 5, 6)):
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        got = t_image.normalize_channels(x, torch.device("cpu"))
        want = np.asarray(j_image.normalize_channels(x))
        assert got.dtype == torch.uint8 and got.is_contiguous()
        assert np.array_equal(got.numpy(), want)


class _Plane:
    """A duck-typed CameraImage plane, attribute-shaped."""

    def __init__(self, data, bytes_per_row=None, bytes_per_pixel=None):
        self.bytes = data
        if bytes_per_row is not None:
            self.bytesPerRow = bytes_per_row
        if bytes_per_pixel is not None:
            self.bytesPerPixel = bytes_per_pixel


def _yuv_planes(rng, w, h):
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8))


def _interleaved(a, b):
    out = np.empty((a.shape[0], 2 * a.shape[1]), np.uint8)
    out[:, 0::2], out[:, 1::2] = a, b
    return out


def _plane_cases(w, h):
    """The plane layouts of the JAX package's ``TestCameraFrameFromPlanes``
    and ``test_pixel_stride2_null_bytes_per_row``, as name -> (planes,
    is_bgra)."""
    rng = np.random.default_rng(w * 100 + h)
    y, u, v = _yuv_planes(rng, w, h)
    cw = u.shape[1]
    uv, vu = _interleaved(u, v), _interleaved(v, u)
    u_view, v_view = uv.reshape(-1)[:-1].tobytes(), vu.reshape(-1)[:-1].tobytes()
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    stride = w * 4 + 8
    padded = np.zeros((h, stride), np.uint8)
    padded[:, :w * 4] = rgba.reshape(h, w * 4)
    y_pad = np.zeros((h, w + 5), np.uint8)
    y_pad[:, :w] = y
    return {
        "i420 three planes": ([_Plane(y.tobytes()),
                               _Plane(u.tobytes(), bytes_per_pixel=1),
                               _Plane(v.tobytes(), bytes_per_pixel=1)], False),
        "pixel stride 2": ([_Plane(y.tobytes()),
                            _Plane(u_view, 2 * cw, 2),
                            _Plane(v_view, 2 * cw, 2)], False),
        "pixel stride 2, no row stride": ([_Plane(y.tobytes()),
                                           _Plane(u_view, bytes_per_pixel=2),
                                           _Plane(v_view, bytes_per_pixel=2)],
                                          False),
        "pixel stride 2, null row stride": (
            [{"bytes": y.tobytes(), "bytes_per_row": None},
             {"bytes": u_view, "bytes_per_row": None, "bytes_per_pixel": 2},
             {"bytes": v_view, "bytes_per_row": None, "bytes_per_pixel": 2}],
            False),
        "padded y rows, short tail": (
            [_Plane(y_pad.reshape(-1)[:-5].tobytes(), w + 5),
             _Plane(u.tobytes()), _Plane(v.tobytes())], False),
        "nv12 two planes": ([_Plane(y.tobytes()), _Plane(uv.tobytes())],
                            False),
        "rgba strided": ([{"bytes": padded.tobytes(), "bytes_per_row": stride,
                           "bytes_per_pixel": 4}], False),
        "bgra strided": ([{"bytes": padded.tobytes(), "bytes_per_row": stride,
                           "bytes_per_pixel": 4}], True),
        "no planes": ([], False),
        "four planes": ([_Plane(y.tobytes())] * 4, False),
        "truncated y": ([_Plane(y.tobytes()[:-9]), _Plane(b"\0" * 32),
                         _Plane(b"\0" * 32)], False),
        "bad pixel stride": ([_Plane(y.tobytes()),
                              _Plane(b"\0" * 16, bytes_per_pixel=3),
                              _Plane(b"\0" * 16, bytes_per_pixel=3)], False),
    }


@pytest.mark.parametrize("w,h", [(96, 64), (31, 10), (9, 11)])
def test_camera_frame_from_planes_matches_jax(w, h):
    """Every plane layout, even and odd sizes, under all four rotations:
    the same frame (or None) and the same decode, bit for bit."""
    for name, (planes, is_bgra) in _plane_cases(w, h).items():
        for rotation in (0, 90, 180, 270):
            got = t_camera.camera_frame_from_planes(
                w, h, planes, t_camera.CameraRotation(rotation), is_bgra)
            want = j_camera.camera_frame_from_planes(
                w, h, planes, j_camera.CameraRotation(rotation), is_bgra)
            assert (got is None) == (want is None), name
            if want is None:
                continue
            assert (got.data, got.width, got.height, got.format.value,
                    int(got.rotation)) == (want.data, want.width, want.height,
                                           want.format.value,
                                           int(want.rotation)), name
            assert np.array_equal(t_camera.decode_camera_frame(got),
                                  j_camera.decode_camera_frame(want)), name
    for bad in ((0, h, [_Plane(b"")]), (w, h, None), ("x", h, [])):
        assert t_camera.camera_frame_from_planes(*bad) is None
        assert j_camera.camera_frame_from_planes(*bad) is None


def test_camera_frame_from_image_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (31, 47, 3), dtype=np.uint8)
    rgba = np.dstack([img, np.full((31, 47), 7, np.uint8)])
    for src in (img, rgba):
        for rotation in (0, 90):
            got = t_camera.camera_frame_from_image(
                src, t_camera.CameraRotation(rotation))
            want = j_camera.camera_frame_from_image(
                src, j_camera.CameraRotation(rotation))
            assert got.data == want.data and got.format.value == "rgba"
            assert np.array_equal(t_camera.decode_camera_frame(got),
                                  j_camera.decode_camera_frame(want))
    for mod in (t_camera, j_camera):
        with pytest.raises(ValueError, match="expected"):
            mod.camera_frame_from_image(np.zeros((4, 4), np.uint8))


# -- FrameThrottle ------------------------------------------------------------


@pytest.mark.parametrize("throttle", [t_video.FrameThrottle,
                                      j_video.FrameThrottle])
def test_frame_throttle(throttle):
    """The cases of the JAX package's ``TestFrameThrottle``, on both
    packages' classes."""
    t = throttle(maxlen=1)
    for f in "abc":
        t.submit(f)
    assert t.take() == "c"
    assert (t.dropped, t.submitted) == (2, 3)

    t = throttle()
    got = []
    th = threading.Thread(target=lambda: got.append(t.take(timeout=5)))
    th.start()
    t.submit("x")
    th.join(timeout=5)
    assert not th.is_alive() and got == ["x"]

    t = throttle()
    t.close()
    assert t.take(timeout=0.1) is None
    with pytest.raises(RuntimeError):
        t.submit("y")


# -- process_video ------------------------------------------------------------

CLIP_FRAMES, CLIP_H, CLIP_W = 12, 96, 128


def _texture_frames(seed: int, n: int, h: int, w: int, pan: int = 2):
    """``n`` RGB frames of a smooth seeded texture (noise at 1/8
    resolution, upscaled) panned ``pan`` px a frame."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 2, (w + pan * n) // 8 + 2, 3),
                         dtype=np.uint8)
    big = cv2.resize(small, (small.shape[1] * 8, small.shape[0] * 8),
                     interpolation=cv2.INTER_CUBIC)
    return [np.ascontiguousarray(big[:h, i * pan:i * pan + w])
            for i in range(n)]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A seeded 12-frame 128x96 mp4v clip at 10 fps, and its frames as
    cv2 decodes them (RGB)."""
    path = str(tmp_path_factory.mktemp("video") / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (CLIP_W, CLIP_H))
    if not writer.isOpened():
        pytest.skip("cv2 cannot write mp4v here")
    for f in _texture_frames(3, CLIP_FRAMES, CLIP_H, CLIP_W):
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    cap = cv2.VideoCapture(path)
    decoded = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        decoded.append(np.ascontiguousarray(f[..., ::-1]))
    cap.release()
    assert len(decoded) == CLIP_FRAMES
    return path, np.stack(decoded)


class _StubDetector:
    """Records each batch and the tracking generation each frame is
    attached with; with ``bump_at``, a reset during that batch."""

    def __init__(self, bump_at=None):
        self._tracking_generation = 0
        self.batches, self.attached = [], []
        self.bump_at = bump_at

    def detect_faces_batch(self, batch, mode):
        self.batches.append(batch.copy())
        if len(self.batches) == self.bump_at:
            self._tracking_generation += 1
        return [[len(self.batches)] for _ in range(len(batch))]

    def _attach_tracking(self, faces, gen0):
        self.attached.append(gen0)
        return faces


def _run_both(path, **kw):
    out = []
    for process, stub in ((t_video.process_video, _StubDetector(2)),
                          (j_video.process_video, _StubDetector(2))):
        res = [(r.frame_index, r.timestamp_s, r.faces)
               for r in process(stub, path, **kw)]
        out.append((res, stub))
    return out


@pytest.mark.parametrize("kw", [
    {}, {"batch_size": 4}, {"batch_size": 5, "frame_stride": 2},
    {"max_frames": 7, "batch_size": 3}, {"max_dim": 64, "batch_size": 8},
    {"max_frames": 0}, {"frame_stride": 3, "max_frames": 3, "max_dim": 100}])
def test_process_video_matches_jax(clip, kw):
    """The same stub detector behind both packages' ``process_video``: the
    same frame indices, timestamps and faces, the same batches (frames
    bit for bit, so also ``max_dim``'s downscale) and the same tracking
    generation read before each batch (a reset inside batch 2 does not
    reach its frames)."""
    path, _ = clip
    (got, gstub), (want, wstub) = _run_both(path, **kw)
    assert got == want
    assert len(gstub.batches) == len(wstub.batches)
    for g, w in zip(gstub.batches, wstub.batches):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert gstub.attached == wstub.attached
    if gstub.batches and len(gstub.batches) > 1:
        assert gstub.attached[len(gstub.batches[0])] == 0


def test_process_video_early_abandon_and_errors(clip):
    """A consumer that stops early stops the prefetch thread (and so
    releases the capture); an unopenable file and a bad stride raise on
    the consumer, as in the JAX package; ``devices=`` builds its
    ``ReplicaPool`` before the reader starts, so a detector the pool
    refuses (a data-parallel one) leaves no reader behind."""
    path, _ = clip
    it = t_video.process_video(_StubDetector(), path, batch_size=2)
    assert next(it).frame_index == 0
    it.close()
    for th in threading.enumerate():
        if th.name == "fdt-video-prefetch":
            th.join(timeout=5)
            assert not th.is_alive()
    for process in (t_video.process_video, j_video.process_video):
        with pytest.raises(ValueError, match="cannot open video"):
            list(process(_StubDetector(), "/nonexistent/clip.mp4"))
        with pytest.raises(ValueError, match="frame_stride"):
            list(process(_StubDetector(), path, frame_stride=0))
    sharded = _StubDetector()
    sharded._mesh = ("cpu", "cpu")
    with pytest.raises(ValueError, match="data_parallel"):
        list(t_video.process_video(sharded, path, devices=["cpu"]))
    assert not any(th.name == "fdt-video-prefetch" and th.is_alive()
                   for th in threading.enumerate())


# -- the detector's tracking surface ----------------------------------------


@pytest.fixture(scope="module")
def tracking_setup(clip):
    """Seeded one-block networks calibrated on the decoded clip (about 12
    candidates a frame), on the CPU."""
    _, frames = clip
    models, *_ = random_init.random_pipeline_models(
        torch.from_numpy(frames), seed=11, detector_blocks=1, mesh_blocks=1,
        per_image=12, iris_blocks=1, mixer_blocks=1)
    return models


def _boxes(faces):
    b = [f.bounding_box for f in faces]
    return [[r.xmin, r.ymin, r.xmax, r.ymax] for r in b]


def test_detector_tracking_matches_jax_tracker(clip, tracking_setup):
    """``detect_faces`` over the clip's frames and
    ``detect_faces_from_video`` give the IDs that the JAX tracker gives on
    the port's own boxes; ``reset_tracking`` restarts the IDs at 1."""
    path, frames = clip
    det = FaceDetector(models=tracking_setup, device="cpu", max_faces=4,
                       enable_tracking=True, max_missed_frames=2)
    assert det.is_tracking_enabled and det.max_missed_frames == 2
    per_frame = [det.detect_faces(f) for f in frames]
    ref = j_tracker.TemporalFaceTracker(max_missed_frames=2)
    assert sum(map(len, per_frame)) >= CLIP_FRAMES
    for faces in per_frame:
        assert [f.tracking_id for f in faces] == ref.update(_boxes(faces))
    det.reset_tracking()
    results = list(det.detect_faces_from_video(path, batch_size=5))
    assert [r.frame_index for r in results] == list(range(CLIP_FRAMES))
    ref = j_tracker.TemporalFaceTracker(max_missed_frames=2)
    for r in results:
        assert [f.tracking_id for f in r.faces] == ref.update(_boxes(r.faces))
    first = next(r.faces for r in results if r.faces)
    assert min(f.tracking_id for f in first) == 1
    # The batch entry points attach no IDs.
    batch = det.detect_faces_batch(frames[:2])
    assert all(f.tracking_id is None for per in batch for f in per)


def test_detector_reset_and_stale_generation(clip, tracking_setup):
    """A result whose detection started before ``reset_tracking`` gets no
    IDs and leaves the fresh tracker empty; the next frame starts at ID 1.
    A negative ``max_missed_frames`` raises.  ``devices=`` (two replicas
    on the CPU) gives the results and IDs of the run without it."""
    path, frames = clip
    with pytest.raises(ValueError, match="max_missed_frames"):
        FaceDetector(models=tracking_setup, device="cpu",
                     enable_tracking=True, max_missed_frames=-1)
    det = FaceDetector(models=tracking_setup, device="cpu", max_faces=4,
                       enable_tracking=True)
    for f in frames[:3]:
        det.detect_faces(f)
    gen0 = det._tracking_generation
    faces = det.detect_faces_batch(frames[3:4])[0]
    assert faces
    det.reset_tracking()
    stale = det._attach_tracking(faces, gen0)
    assert all(f.tracking_id is None for f in stale)
    assert det._tracker.active_track_count == 0
    fresh = det.detect_faces(frames[3])
    assert sorted(f.tracking_id for f in fresh) == \
        list(range(1, len(fresh) + 1))
    det.reset_tracking()
    want = list(det.detect_faces_from_video(path, batch_size=2))
    det.reset_tracking()
    got = list(det.detect_faces_from_video(path, batch_size=2,
                                           devices=["cpu", "cpu"]))
    assert [(r.frame_index, r.timestamp_s) for r in got] == \
        [(r.frame_index, r.timestamp_s) for r in want]
    for g, w in zip(got, want):
        _same_faces(g.faces, w.faces)
        assert [f.tracking_id for f in g.faces] == \
            [f.tracking_id for f in w.faces]
    untracked = FaceDetector(models=tracking_setup, device="cpu")
    assert not untracked.is_tracking_enabled
    assert all(f.tracking_id is None for f in untracked.detect_faces(frames[0]))


def _same_faces(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _boxes([g]) == _boxes([w]) and g.score == w.score
        assert np.array_equal(g.mesh.points, w.mesh.points)
        assert np.array_equal(g.iris_points, w.iris_points)


def test_negative_stride_frames_match_contiguous_copies(clip, tracking_setup):
    """``frame[..., ::-1]`` (the video reader's BGR-to-RGB view) and
    ``np.rot90`` (the camera rotation) are negative-stride views, which
    ``torch.from_numpy`` refuses: every entry point gives the same faces
    as for their contiguous copies."""
    _, frames = clip
    det = FaceDetector(models=tracking_setup, device="cpu", max_faces=4)
    for view in (frames[0][..., ::-1], np.rot90(frames[1]),
                 np.rot90(frames[2], 3)[::-1]):
        assert any(s < 0 for s in view.strides)
        _same_faces(det.detect_faces(view),
                    det.detect_faces(np.ascontiguousarray(view)))
    views = np.rot90(frames[:3], axes=(1, 2))
    for g, w in zip(det.detect_faces_batch(views),
                    det.detect_faces_batch(np.ascontiguousarray(views))):
        _same_faces(g, w)


def _rgb_to_i420(rgb):
    """BT.601 video-range RGB -> I420 planes, as the JAX camera tests make
    them."""
    r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
    y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128 + 0.439 * r - 0.368 * g - 0.071 * b
    return tuple(np.clip(p, 0, 255).astype(np.uint8)
                 for p in (y, u[::2, ::2], v[::2, ::2]))


def test_camera_entry_points_equal_detect_faces(tracking_setup, clip):
    """``detect_faces_from_camera_frame`` and ``_camera_image`` equal
    ``detect_faces`` on the decoded frame; an undecodable layout gives no
    faces and a shapeless object raises TypeError."""
    _, frames = clip
    det = FaceDetector(models=tracking_setup, device="cpu", max_faces=4)
    rgb = frames[5]
    y, u, v = _rgb_to_i420(rgb)
    for rotation in (0, 90, 180, 270):
        frame = t_camera.CameraFrame(y.tobytes() + u.tobytes() + v.tobytes(),
                                     CLIP_W, CLIP_H,
                                     t_camera.CameraFormat.I420,
                                     t_camera.CameraRotation(rotation))
        want = det.detect_faces(t_camera.decode_camera_frame(frame))
        _same_faces(det.detect_faces_from_camera_frame(frame), want)
        image = {"width": CLIP_W, "height": CLIP_H,
                 "planes": [_Plane(y.tobytes()), _Plane(u.tobytes()),
                            _Plane(v.tobytes())]}
        _same_faces(det.detect_faces_from_camera_image(
            image, rotation=t_camera.CameraRotation(rotation)), want)
    half = det.detect_faces_from_camera_frame(frame, max_dim=64)
    assert all(f.original_size == (48, 64) for f in half)
    assert det.detect_faces_from_camera_image(
        {"width": CLIP_W, "height": CLIP_H, "planes": []}) == []
    with pytest.raises(TypeError, match="width, height and planes"):
        det.detect_faces_from_camera_image(object())

