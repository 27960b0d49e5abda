"""The port's serving path on the CPU: the software-pipelined stream, the
pinned-upload entry, ``ServingPipeline``, the micro-batching
``FaceServer`` with ``_Batcher`` and ``_AdaptiveCap``, the decode layer and
the encoded-input entry points, against the port's own batch calls and
against the JAX package where it has the same function.

Faces are held to one another with the tolerances of the smoke run's
serving phase: counts and validity equal; boxes, scores and blendshapes
within 1e-6; mesh, iris and eye landmarks within one step of the int16
readback (plus float rounding); head angles within 1e-3 degree."""

import io
import json
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                         FaceServer, ServingPipeline)
from face_detection_tflite_torch.convert import executor as t_exec
from face_detection_tflite_torch.pipeline import server as t_server
from face_detection_tflite_torch.pipeline.upload import upload
from face_detection_tflite_torch.utils import image as t_image
from face_detection_tflite_torch.utils import native as t_native
from face_detection_tflite_tpu.pipeline import server as j_server
from face_detection_tflite_tpu.utils import image as j_image

from .test_torch_pipeline import _jax_slab
from .torch_parity import H, MAX_FACES, W, small_pipeline

FULL, STANDARD, FAST = (FaceDetectionMode.FULL, FaceDetectionMode.STANDARD,
                        FaceDetectionMode.FAST)


@pytest.fixture(scope="module")
def setup():
    return small_pipeline()


def _detector(models, **kw):
    return FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                        allow_untrained_embeddings=True, **kw)


def _tolerances(h, w):
    return {"unit": 1e-6, "px": 2.0 * max(h, w) / 32000.0 + 1e-3,
            "degrees": 1e-3}


def _errors(got, want, path="", errs=None):
    """Max abs difference of two ``Face.to_dict`` payloads (or lists of
    them) by kind of value; asserts that their structure is equal."""
    errs = {} if errs is None else errs
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _errors(got[k], want[k], f"{path}/{k}", errs)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _errors(g, w, f"{path}/{i}", errs)
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        kind = ("px" if any(f"/{k}" in path
                            for k in ("mesh", "eyes", "landmarks")) else
                "degrees" if "head_euler_angles" in path else "unit")
        errs[kind] = max(errs.get(kind, 0.0), abs(float(got) - float(want)))
    else:
        assert got == want, path
    return errs


def _payload(faces, **flags):
    flags = flags or {"include_mesh": True, "include_iris": True}
    return json.loads(json.dumps([[f.to_dict(**flags) for f in per]
                                  for per in faces]))


def _assert_faces_match(got, want, h=H, w=W, **flags):
    """Per-image Face lists (or their JSON payloads) within the serving
    tolerances."""
    got = got if _is_payload(got) else _payload(got, **flags)
    want = want if _is_payload(want) else _payload(want, **flags)
    errs = _errors(got, want)
    tol = _tolerances(h, w)
    assert all(errs.get(k, 0.0) <= t for k, t in tol.items()), errs


def _is_payload(x):
    """Whether per-image face lists hold payloads (dicts) already; lists
    without a face are taken as they are."""
    return all(isinstance(f, dict) for per in x for f in per)


def _crop(frames):
    """A second shape: the frames cut to 80x128."""
    return np.ascontiguousarray(frames[:, :80, :128])


def _png(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", **kw)
    return buf.getvalue()


def _jpeg(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


# -- the stream -----------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_matches_batch_calls(setup, depth):
    """Batch by batch, the stream equals ``detect_faces_batch`` on the same
    batches (an empty batch and two shapes among them); its STANDARD faces
    of the first batch are the JAX program's slab."""
    frames, models, jmodels = setup
    batches = [frames, frames[:0], _crop(frames), frames[::-1].copy(),
               frames[:1]]
    for mode in (FULL, STANDARD):
        ref_det = _detector(models)
        want = [ref_det.detect_faces_batch(b, mode) for b in batches]
        det = _detector(models)
        got = list(det.detect_faces_batch_stream(batches, mode, depth=depth))
        assert len(got) == len(batches) and got[1] == []
        for g, w_, b in zip(got, want, batches):
            _assert_faces_match(g, w_, b.shape[1], b.shape[2])
    ref = _jax_slab(jmodels, frames, min_score=0.5)
    for i, faces in enumerate(got[0]):
        keep = np.flatnonzero(ref["valid"][i] & (ref["mesh_scores"][i] >= 0.5))
        assert len(faces) == len(keep) >= 1
        tol = max(1e-2, 1e-5 * np.abs(ref["mesh"]).max())
        for face, d in zip(faces, keep):
            bb = face.bounding_box
            assert np.abs(np.asarray([bb.xmin, bb.ymin, bb.xmax, bb.ymax])
                          - ref["boxes"][i, d]).max() <= 1e-4
            assert np.abs(face.mesh.points - ref["mesh"][i, d]).max() <= tol


def test_stream_rejects_bad_arguments(setup):
    _, models, _ = setup
    det = _detector(models)
    with pytest.raises(ValueError, match="depth"):
        next(det.detect_faces_batch_stream([], depth=0))
    with pytest.raises(NotImplementedError, match="item 7"):
        next(det.detect_faces_batch_stream([], devices=["cpu"]))
    with pytest.raises(ValueError, match="channel"):
        next(det.detect_faces_batch_stream([np.zeros((1, 8, 8, 5),
                                                     np.uint8)]))


def test_orig_sizes_pad_two_sizes_into_one_batch(setup):
    """With ``bucket_images``, two sizes padded into one 256x256 batch with
    ``_orig_sizes`` give the faces of the per-size calls."""
    frames, models, _ = setup
    det = _detector(models, bucket_images=True)
    a, c = frames[0], _crop(frames)[1]
    padded = np.zeros((2, 256, 256, 3), np.uint8)
    padded[0, :H, :W] = a
    padded[1, :80, :128] = c
    got = det.detect_faces_batch(padded, FULL,
                                 _orig_sizes=[(W, H), (128, 80)])
    want = det.detect_faces_batch(a[None], FULL) + \
        det.detect_faces_batch(c[None], FULL)
    assert sum(map(len, got)) >= 2
    _assert_faces_match(got, want, 256, 256)


def test_upload_on_the_cpu():
    """The CPU device skips the staging: uint8 is kept without a copy,
    other dtypes become float32, a tensor there passes through."""
    a = np.arange(24, dtype=np.uint8).reshape(1, 2, 4, 3)
    t = upload(a, torch.device("cpu"))
    assert t.dtype == torch.uint8 and t.data_ptr() == a.ctypes.data
    f = upload(a.astype(np.float64), torch.device("cpu"))
    assert f.dtype == torch.float32 and torch.equal(f, t.float())
    assert upload(t, torch.device("cpu")) is t


# -- ServingPipeline ---------------------------------------------------------------


def test_pipeline_results_in_submit_order(setup):
    frames, models, _ = setup
    det = _detector(models)
    batches = [frames, _crop(frames), frames[::-1].copy(), frames[:1],
               [_png(f) for f in frames]]
    want = [_detector(models).detect_faces_batch(
        np.stack([t_image.decode_image(x) for x in b]) if isinstance(b, list)
        else b, STANDARD) for b in batches]
    with ServingPipeline(det, STANDARD, depth=2) as pipe:
        futs = [pipe.submit(b) for b in batches]
        assert all(f.fdt_stream == id(pipe) for f in futs)
        got = [f.result(timeout=120) for f in futs]
    for g, w_, b in zip(got, want, batches):
        hw = (H, W) if isinstance(b, list) else b.shape[1:3]
        _assert_faces_match(g, w_, *hw)


class _GatedDetector:
    """Stands in for a detector: the first dispatch waits for ``start``,
    every finish for ``gate``; it records the dispatched batches' tags and
    the most batches alive at once (dispatched, not yet finished)."""

    device = torch.device("cpu")

    def __init__(self):
        self.start, self.gate = threading.Event(), threading.Event()
        self.dispatched = []
        self.live = self.most_live = 0
        self.lock = threading.Lock()

    def _stream_dispatch(self, images, mode, orig_sizes=None):
        self.start.wait(30)
        with self.lock:
            self.dispatched.append(int(images[0, 0, 0, 0]))
            self.live += 1
            self.most_live = max(self.most_live, self.live)
        return images

    def _stream_finish(self, handle, mode):
        self.gate.wait(30)
        with self.lock:
            self.live -= 1
        return [[] for _ in range(handle.shape[0])]


def _batch(tag):
    return np.full((1, 4, 4, 3), tag, np.uint8)


def test_pipeline_bounds_cancel_and_close():
    """At most 2·depth + 1 batches alive (depth + 1 dispatched, depth
    queued); ``try_submit`` gives None when the queue is full; a Future
    cancelled while queued is skipped; a closed pipeline and a malformed
    batch raise on submit."""
    depth = 2
    det = _GatedDetector()
    pipe = ServingPipeline(det, FAST, depth=depth)
    with pytest.raises(ValueError, match="channel"):
        pipe.submit(np.zeros((1, 4, 4, 5), np.uint8))
    futs = [pipe.submit(_batch(t)) for t in (1, 2, 3)]
    det.start.set()
    deadline = time.monotonic() + 30
    while len(det.dispatched) < depth + 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    queued = [pipe.try_submit(_batch(t)) for t in (4, 5)]
    assert all(f is not None for f in queued)
    assert pipe.try_submit(_batch(6)) is None
    assert det.live + pipe._q.qsize() == 2 * depth + 1
    assert queued[0].cancel()
    det.gate.set()
    for f in [*futs, queued[1]]:
        assert f.result(timeout=30) == [[]]
    pipe.close()
    assert det.dispatched == [1, 2, 3, 5]
    assert det.most_live == depth + 1
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(_batch(7))


def test_pipeline_refuses_other_devices_and_segmentation(setup):
    _, models, _ = setup
    det = _detector(models)
    for device in ("cuda", "cuda:1", "meta"):
        with pytest.raises(NotImplementedError, match="item 7"):
            ServingPipeline(det, device=device)
    with pytest.raises(NotImplementedError, match="item 8"):
        ServingPipeline(det, with_segmentation=True)
    with pytest.raises(ValueError, match="depth"):
        ServingPipeline(det, depth=0)
    ServingPipeline(det, device="cpu").close()


# -- _AdaptiveCap -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_cap_matches_jax(seed):
    """Fed the same seeded records, completions, cap reads and peeks, the
    port's cap equals the JAX package's at every step (fewer than 128
    streams, one thread: where the two fixes change nothing)."""
    rng = random.Random(seed)
    caps = [t_server._AdaptiveCap(16, explore_every=7),
            j_server._AdaptiveCap(16, explore_every=7)]
    t = 0.0
    for step in range(400):
        op = rng.random()
        n = rng.choice([1, 2, 3, 4, 6, 8, 12, 16])
        if op < 0.35:
            secs = rng.uniform(0.001, 0.05) * (n ** rng.uniform(0.3, 1.1))
            for c in caps:
                c.record(n, secs)
        elif op < 0.7:
            t += rng.uniform(0.0, 0.02)
            done = t + rng.uniform(-0.005, 0.05)
            stream = rng.choice([None, 1, 2, 3])
            for c in caps:
                c.record_completion(n, t, done, stream)
        else:
            got = [c.cap for c in caps] if op < 0.9 else \
                [c.peek() for c in caps]
            assert got[0] == got[1], step
        assert caps[0].snapshot() == caps[1].snapshot(), step


def test_adaptive_cap_evicts_the_least_recently_updated_stream():
    """The port re-inserts a stream on each update, so the eviction past
    128 streams drops the stream idle longest; the JAX package drops the
    first-inserted one, here the busiest."""
    port, jax_cap = t_server._AdaptiveCap(16), j_server._AdaptiveCap(16)
    for c in (port, jax_cap):
        c.record_completion(1, 0.0, 1.0, stream="busy")
        for i in range(128):
            c.record_completion(1, 0.0, 1.5 + i, stream="busy")
            c.record_completion(1, 0.0, 2.0 + i, stream=i)
    assert "busy" in port._last_done and 0 not in port._last_done
    assert "busy" not in jax_cap._last_done
    # The busy stream's next interval starts at its last completion.
    before = port.snapshot()[1]
    port.record_completion(1, 0.0, 129.0, stream="busy")
    assert port.snapshot()[1] == pytest.approx(
        before + 0.3 * ((129.0 - 128.5) - before))


def test_adaptive_cap_records_a_completion_under_its_lock():
    """The interval is computed and recorded in one critical section: the
    EWMA update sees the lock held and the stream's completion stored."""
    cap = t_server._AdaptiveCap(16)
    seen = []
    inner = cap._record_locked

    def spy(n, seconds):
        seen.append((cap._lock.locked(), cap._last_done.get("s"), seconds))
        inner(n, seconds)

    cap._record_locked = spy
    cap.record_completion(2, 1.0, 1.5, stream="s")
    cap.record_completion(2, 1.2, 1.9, stream="s")
    assert seen == [(True, 1.5, 0.5), (True, 1.9, pytest.approx(0.4))]


# -- _Batcher -------------------------------------------------------------------------


class _StubDetector:
    def __init__(self, fail=False):
        self.batches = []
        self.fail = fail

    def detect_faces_batch(self, imgs, mode):
        if self.fail:
            raise RuntimeError("boom")
        self.batches.append((imgs.shape[0], imgs.shape[1:], mode))
        return [[] for _ in range(imgs.shape[0])]


@pytest.mark.parametrize("case", ["same_shape", "mixed_shapes", "max_batch",
                                  "detector_error", "malformed"])
def test_batcher(case):
    det = _StubDetector(fail=case == "detector_error")
    b = t_server._Batcher(det, window_ms=200.0,
                          max_batch=4 if case == "max_batch" else 16)
    a, c = np.zeros((32, 32, 3), np.uint8), np.zeros((64, 48, 3), np.uint8)
    imgs = {"same_shape": [a] * 5, "mixed_shapes": [a, c, a],
            "max_batch": [a] * 6, "detector_error": [a],
            "malformed": [b"no shape", a]}[case]
    futs = [b.submit(x, FAST) for x in imgs]
    if case == "detector_error":
        with pytest.raises(RuntimeError, match="boom"):
            futs[0].result(timeout=30)
    elif case == "malformed":
        with pytest.raises(AttributeError):
            futs[0].result(timeout=30)
        assert futs[1].result(timeout=30) == []
    else:
        assert all(f.result(timeout=30) == [] for f in futs)
    b.close()
    sizes = sorted(n for n, _, _ in det.batches)
    assert sizes == {"same_shape": [5], "mixed_shapes": [1, 2],
                     "max_batch": [2, 4], "detector_error": [],
                     "malformed": [1]}[case]


def test_batcher_close_resolves_queued_requests():
    """A request left behind the shutdown sentinel resolves with "server
    closed"; after close a submit raises."""
    gate = threading.Event()

    class Slow(_StubDetector):
        def detect_faces_batch(self, imgs, mode):
            gate.wait(30)
            return super().detect_faces_batch(imgs, mode)

    from concurrent.futures import Future
    b = t_server._Batcher(Slow(), window_ms=1.0, max_batch=1)
    img = np.zeros((8, 8, 3), np.uint8)
    first = b.submit(img, FAST)
    time.sleep(0.05)
    b._q.put(None)
    behind = Future()
    b._q.put((img, FAST, behind))
    gate.set()
    assert first.result(timeout=30) == []
    with pytest.raises(RuntimeError, match="server closed"):
        behind.result(timeout=30)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(img, FAST)


# -- FaceServer over HTTP ---------------------------------------------------------------


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def served(setup):
    frames, models, _ = setup
    det = _detector(models)
    srv = FaceServer(det, batch_window_ms=50.0).start()
    yield srv, det, frames
    srv.close()


def test_server_health_info_and_metrics(served):
    srv, det, frames = served
    status, body = _get(f"{srv.address}/healthz")
    assert status == 200 and json.loads(body) == {"status": "ok",
                                                  "ready": True}
    status, body = _get(f"{srv.address}/v1/info")
    info = json.loads(body)
    assert status == 200 and info["model_version"] == 1
    assert info["accelerator_report"]["detector"] == "cpu"
    assert info["embedding_pretrained"] is False
    assert info["segmentation_ready"] is False
    assert info["replica_devices"] is None and info["replica_stats"] is None
    assert info["memory_report"]["total_weights"] == sum(
        v for k, v in info["memory_report"].items()
        if k not in ("total_weights", "compiled_programs"))
    _post(f"{srv.address}/v1/detect", _png(frames[0]))
    status, body = _get(f"{srv.address}/metrics")
    assert status == 200 and b"fdt_requests_total" in body
    assert b"fdt_detect_batch_size_count" in body


@pytest.mark.parametrize("mode,flags", [
    ("fast", ""), ("standard", "&mesh=1&contours=1"),
    ("full", "&mesh=1&iris=1&embedding=1")])
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_server_detect_matches_batch_calls(served, mode, flags, fmt):
    srv, det, frames = served
    body = (_png if fmt == "png" else _jpeg)(frames[1])
    img = t_image.decode_image(body)
    status, payload, _ = _post(f"{srv.address}/v1/detect?mode={mode}{flags}",
                               body)
    assert status == 200 and payload["mode"] == mode
    assert payload["image"] == {"width": W, "height": H}
    want = det.detect_faces_batch(img[None], FaceDetectionMode(mode))
    kw = {"include_mesh": "mesh=1" in flags,
          "include_contours": "contours=1" in flags,
          "include_iris": "iris=1" in flags,
          "include_embedding": "embedding=1" in flags}
    _assert_faces_match([payload["faces"]], _payload(want, **kw))


@pytest.mark.parametrize("path,body,status", [
    ("/v1/detect?mode=bogus", "png", 400), ("/v1/detect", "garbage", 400),
    ("/v1/detect", "empty", 400), ("/v1/nowhere", "png", 404),
    ("/v1/segment", "png", 500), ("/v1/detect_with_segmentation", "png",
                                  500)])
def test_server_errors(served, path, body, status):
    srv, _, frames = served
    data = {"png": _png(frames[0]), "garbage": b"not an image at all",
            "empty": b""}[body]
    got, payload, _ = _post(f"{srv.address}{path}", data)
    assert got == status and "error" in payload
    if status == 500:
        assert "not ported" in payload["error"]
    if path == "/v1/nowhere":
        assert _get(f"{srv.address}{path}")[0] == 404


def test_server_batches_concurrent_requests(served):
    srv, det, frames = served
    body = _png(frames[0])
    sizes = []
    orig = srv._batcher._metrics["batch_size"]

    class Recorder:
        def observe(self, v):
            sizes.append(v)
            orig.observe(v)

    srv._batcher._metrics["batch_size"] = Recorder()
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        _post(f"{srv.address}/v1/detect?mode=full", body)))
        for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv._batcher._metrics["batch_size"] = orig
    assert [r[0] for r in results] == [200] * 6
    assert max(sizes) > 1 and sum(sizes) == 6
    want = _payload(det.detect_faces_batch(frames[:1]),
                    include_embedding=True)
    for _, payload, _ in results:
        _assert_faces_match([payload["faces"]], want)


def test_server_embed(served):
    srv, det, frames = served
    status, payload, _ = _post(f"{srv.address}/v1/embed", _png(frames[0]))
    assert status == 200 and payload["pretrained"] is False
    faces = det.detect_faces(frames[0], STANDARD)
    want = det.get_face_embeddings(faces, frames[0])
    assert len(payload["faces"]) == len(want) >= 1
    for f, w_ in zip(payload["faces"], want):
        e = np.asarray(f["embedding"])
        assert abs(np.linalg.norm(e) - 1) <= 1e-4
        assert np.abs(e - w_).max() <= 1e-4


def test_server_sheds_with_retry_after_and_recovers(setup):
    frames, models, _ = setup
    det = _detector(models)
    gate = threading.Event()
    orig = det._stream_dispatch

    def gated(raw, mode, orig_sizes=None, **kw):
        gate.wait(60)
        return orig(raw, mode, orig_sizes, **kw)

    det._stream_dispatch = gated
    srv = FaceServer(det, batch_window_ms=1.0, max_batch=1,
                     max_queue=2).start()
    body = _png(frames[0])
    results = []
    try:
        threads = [threading.Thread(target=lambda: results.append(
            _post(f"{srv.address}/v1/detect?mode=fast", body)))
            for _ in range(10)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                not any(r[0] == 503 for r in list(results)):
            time.sleep(0.02)
        assert srv._batcher.queue_depth <= 2
        gate.set()
        for t in threads:
            t.join(60)
        statuses = sorted(r[0] for r in results)
        assert statuses.count(503) >= 1 and set(statuses) <= {200, 503}
        for status, payload, headers in results:
            if status == 503:
                assert "queue full" in payload["error"]
                assert headers.get("Retry-After") == "1"
        assert _post(f"{srv.address}/v1/detect?mode=fast", body)[0] == 200
        _, metrics = _get(f"{srv.address}/metrics")
        assert b"fdt_requests_shed_total" in metrics
    finally:
        gate.set()
        srv.close()


@pytest.mark.parametrize("adaptive", [True, False])
def test_server_recycle_and_cap_gauge(setup, adaptive):
    frames, models, _ = setup
    det = _detector(models)
    srv = FaceServer(det, recycle_after_batches=1,
                     adaptive_batch=adaptive).start()
    try:
        body = _png(frames[0])
        for _ in range(2):
            assert _post(f"{srv.address}/v1/detect?mode=fast", body)[0] == 200
        _, metrics = _get(f"{srv.address}/metrics")
        values = dict(line.split() for line in metrics.decode().splitlines()
                      if line and not line.startswith("#") and " " in line
                      and "{" not in line)
        recycles = float(values["fdt_worker_recycles_total"])
        cap = float(values["fdt_adaptive_batch_cap"])
        assert recycles >= 1
        assert (cap > 0) == adaptive
        assert (srv._adaptive_cap is None) == (not adaptive)
        assert det._decode_cache is None and det._devput_cache is None
    finally:
        srv.close()
    with pytest.raises(NotImplementedError, match="item 7"):
        FaceServer(det, devices=["cuda:0"])


# -- decode ----------------------------------------------------------------------------


def _images():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    return {"png": _png(rgb), "png_gray": _png(rgb[..., 0]),
            "png_rgba": _png(np.dstack([rgb, rgb[..., :1]])),
            "jpeg": _jpeg(rgb), "webp": _webp(rgb)}


def _webp(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", lossless=True)
    return buf.getvalue()


@pytest.mark.parametrize("native", [True, False])
def test_decode_matches_jax(native, monkeypatch):
    """The port's decode equals the JAX package's on PNG, JPEG and WebP
    (with the native pool, and without it through PIL) and raises
    ValueError on garbage."""
    if not native:
        monkeypatch.setattr(t_image, "_native_pool", lambda: None)
    elif not t_native.native_available():
        pytest.skip(f"native decoder {t_native.runtime_status()}")
    datas = _images()
    for name, data in datas.items():
        got = t_image.decode_image(data)
        np.testing.assert_array_equal(got, j_image.decode_image(data), name)
        assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    for g, w_ in zip(t_image.decode_images(list(datas.values())),
                     j_image.decode_images(list(datas.values()))):
        np.testing.assert_array_equal(g, w_)
    with pytest.raises(ValueError):
        t_image.decode_image(b"\x89PNG\r\n\x1a\n garbage")
    with pytest.raises(ValueError):
        t_image.decode_image(b"garbage")


def test_validate_batch_shape():
    for shape in ((2, 4, 4, 3), (2, 4, 4, 1), (2, 4, 4, 4), (2, 4, 5)):
        t_image.validate_batch_shape(shape)
    for shape, match in (((4, 4, 3), "ambiguous"), ((4, 4), "expected"),
                         ((1, 4, 4, 2), "channel")):
        with pytest.raises(ValueError, match=match):
            t_image.validate_batch_shape(shape)


# -- encoded-input entry points and the detector surface ---------------------------


def test_encoded_entry_points_match_array_calls(setup, tmp_path):
    frames, models, _ = setup
    det = _detector(models)
    png = _png(frames[0])
    want = det.detect_faces(frames[0])
    _assert_faces_match([det.detect_faces_from_bytes(png)], [want])
    assert det._decode_cache[0] == png
    path = tmp_path / "frame.png"
    path.write_bytes(png)
    _assert_faces_match([det.detect_faces_from_filepath(str(path))], [want])
    emb = det.get_face_embedding_from_bytes(want[0], png)
    np.testing.assert_allclose(
        emb, det.get_face_embedding(want[0], frames[0]), atol=1e-6)
    np.testing.assert_allclose(
        det.get_face_embedding_from_filepath(want[0], str(path)), emb,
        atol=1e-6)
    crop = _crop(frames)[1]
    for bucket in (False, True):
        d = _detector(models, bucket_images=bucket)
        got = d.detect_faces_from_bytes_batch([png, _png(crop), png])
        ref = _detector(models, bucket_images=bucket)
        _assert_faces_match(got, [ref.detect_faces(frames[0]),
                                  ref.detect_faces(crop),
                                  ref.detect_faces(frames[0])])
    det.dispose()
    assert det._decode_cache is None and not det.is_ready


def test_detector_reports(setup):
    _, models, _ = setup
    det = _detector(models)
    assert det.MODEL_VERSION == 1
    assert det.is_ready and det.is_embedding_ready
    assert not det.is_segmentation_ready
    report = det.accelerator_report
    assert report["detector"] == "cpu" and report["precision"] == "highest"
    mem = det.memory_report()
    assert mem["detector"] == sum(t.numel() * 4 for t in
                                  models.detector.buffers())
    assert mem["total_weights"] == sum(mem[k] for k in (
        "detector", "mesh", "iris", "blendshapes", "embedding"))
    for call in (lambda: det.get_segmentation_mask_from_bytes(b""),
                 lambda: det.detect_faces_with_segmentation_from_bytes(b"")):
        with pytest.raises(NotImplementedError, match="item 8"):
            call()


# -- the fp32 guard -----------------------------------------------------------------------


def test_fp32_guard_checks_without_toggling(monkeypatch):
    """A forward on a CUDA device raises while TF32 is on in cuDNN or
    cuBLAS, and the guard changes no flag; building a card model turns
    cuDNN's TF32 off once; the CPU is never refused."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="cudnn.allow_tf32"):
        t_exec._check_fp32(cuda)
    assert torch.backends.cudnn.allow_tf32 is True
    t_exec._check_fp32(torch.device("cpu"))
    t_exec.fp32_on_the_card(torch.device("cpu"))
    assert torch.backends.cudnn.allow_tf32 is True
    t_exec.fp32_on_the_card(cuda)
    assert torch.backends.cudnn.allow_tf32 is False
    t_exec._check_fp32(cuda)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="matmul.allow_tf32"):
        t_exec._check_fp32(cuda)
