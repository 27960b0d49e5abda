"""The port's scale-out on the CPU (``parallel/sharding.py``,
``parallel/replica.py`` and the surface that uses them), against the JAX
package on the same seeded networks.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's
devices are the CPU repeated (``[cpu] * k``), and its mesh reaches
``FaceDetector`` through the one seam, ``sharding.visible_devices``.
Whole-batch replica results are held bit for bit to the same detector's
own calls; sharded results to the unsharded ones within the JAX tests'
bounds (boxes 1e-5, scores 1e-6, ``tests/test_parallel.py``); port against
JAX within the pipeline tests' tolerances (boxes and keypoints 1e-4,
scores 1e-5, landmarks ``max(1e-2, 1e-5·|ref|)``), and sharded against
sharded within the JAX bounds as well."""

import json
import os
import sys
import threading
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                         FaceServer, ReplicaPool,
                                         ServingPipeline,
                                         build_pipeline_program)
from face_detection_tflite_torch.parallel import replica as t_replica
from face_detection_tflite_torch.parallel import sharding
from face_detection_tflite_tpu import ReplicaPool as JReplicaPool
from face_detection_tflite_tpu.parallel import sharding as j_sharding
from face_detection_tflite_tpu.pipeline import detector as j_detector
from face_detection_tflite_tpu.pipeline import programs as j_programs
from face_detection_tflite_tpu.pipeline import server as j_server
from face_detection_tflite_tpu.pipeline import video as j_video
from face_detection_tflite_tpu.pipeline.config import \
    FaceDetectionMode as JMode
from face_detection_tflite_tpu.pipeline.config import MODEL_FILES

from .test_torch_serving import _assert_faces_match, _get, _png, _post
from .test_torch_tracking import clip  # noqa: F401  (a fixture)
from .torch_parity import H, MAX_FACES, W, small_pipeline

FAST, STANDARD, FULL = (FaceDetectionMode.FAST, FaceDetectionMode.STANDARD,
                        FaceDetectionMode.FULL)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    return small_pipeline()


@pytest.fixture
def mesh_of(monkeypatch):
    """Makes ``visible_devices`` return the CPU ``n`` times."""
    def make(n):
        monkeypatch.setattr(sharding, "visible_devices",
                            lambda kind="cuda": [CPU] * n)
    return make


@pytest.fixture
def jax_detector(monkeypatch):
    """The JAX FaceDetector on the seeded JAX networks, loaded by file
    name.  Never disposed: that would empty the shared networks'
    params."""
    monkeypatch.setenv("FDT_NO_COMPILE_CACHE", "1")

    def make(jmodels, **kw):
        by_file = {MODEL_FILES["back"]: jmodels.detector,
                   MODEL_FILES["face_landmark"]: jmodels.mesh,
                   MODEL_FILES["iris_landmark"]: jmodels.iris,
                   MODEL_FILES["face_blendshapes"]: jmodels.blendshapes}
        monkeypatch.setattr(j_detector, "resolve_model_dir",
                            lambda model_dir=None: "seeded")
        monkeypatch.setattr(j_detector, "convert_file",
                            lambda path, precision="highest":
                            by_file[os.path.basename(path)])
        return j_detector.FaceDetector(max_faces=MAX_FACES, **kw)
    return make


def _detector(models, **kw):
    return FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                        **kw)


def _box(f):
    b = f.bounding_box
    return np.asarray([b.xmin, b.ymin, b.xmax, b.ymax])


def _tol(ref):
    return max(1e-2, 1e-5 * np.abs(ref).max())


def _bit_equal(got, want):
    """Per-image Face lists equal bit for bit."""
    assert [len(f) for f in got] == [len(f) for f in want]
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert np.array_equal(_box(g), _box(w)) and g.score == w.score
            assert np.array_equal(g.detection_data.keypoints_xy,
                                  w.detection_data.keypoints_xy)
            if w.mesh is not None:
                assert np.array_equal(g.mesh.points, w.mesh.points)
            assert np.array_equal(g.iris_points, w.iris_points)


def _within_jax_bounds(got, want):
    """The JAX tests' bounds for sharded against unsharded results:
    equal face counts, boxes within 1e-5, scores within 1e-6."""
    assert [len(f) for f in got] == [len(f) for f in want]
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert np.abs(_box(g) - _box(w)).max() <= 1e-5
            assert abs(g.score - w.score) <= 1e-6


def _match_jax(got, ref, mode):
    """Port faces against the JAX package's, within the pipeline tests'
    tolerances."""
    assert [len(f) for f in got] == [len(f) for f in ref]
    for g_img, r_img in zip(got, ref):
        for g, r in zip(g_img, r_img):
            assert np.abs(_box(g) - _box(r)).max() <= 1e-4
            assert abs(g.score - r.score) <= 1e-5
            assert np.abs(g.detection_data.keypoints_xy - np.asarray(
                r.detection_data.keypoints_xy)).max() <= 1e-4
            if mode != FAST:
                assert np.abs(g.mesh.points - r.mesh.points).max() <= \
                    _tol(r.mesh.points)
            if mode == FULL:
                assert np.abs(g.iris_points - r.iris_points).max() <= \
                    _tol(r.iris_points)


def _batches(frames, n):
    """``n`` two-image batches, each the frames rolled a few pixels."""
    return [np.ascontiguousarray(np.roll(frames, 3 * i, axis=2))
            for i in range(n)]


# -- the sharding functions ------------------------------------------------


def test_visible_devices_and_make_mesh(mesh_of):
    assert sharding.visible_devices("cpu") == [CPU]
    assert sharding.make_mesh(["cpu"] * 3) == (CPU,) * 3
    assert sharding.make_mesh(kind="cpu") == (CPU,)
    with pytest.raises(ValueError, match="at least one"):
        sharding.make_mesh([])
    mesh_of(8)
    assert sharding.make_mesh() == (CPU,) * 8


def test_shard_batch_and_params(setup):
    _, models, _ = setup
    x = torch.arange(8 * 3).reshape(8, 3)
    shards = sharding.shard_batch(x, (CPU,) * 4)
    assert [s.tolist() for s in shards] == [x[i:i + 2].tolist()
                                            for i in range(0, 8, 2)]
    assert all(s.data_ptr() == x[2 * i].data_ptr()    # views, no copy
               for i, s in enumerate(shards))
    with pytest.raises(ValueError, match="equal shards"):
        sharding.shard_batch(x, (CPU,) * 3)
    assert sharding.shard_params(models, (CPU,) * 8) == {CPU: models}


def test_replicate_copies_the_weights_to_another_device(setup):
    """``PipelineModels.replicate``: itself on its own device, a copy of
    every network's weights on another (``meta`` stands in for a second
    card)."""
    _, models, _ = setup
    assert models.replicate("cpu") is models
    copy = models.replicate("meta")
    assert copy.device.type == "meta" and copy.variant == models.variant
    for name in ("detector", "mesh", "iris", "blendshapes", "embedding"):
        src, dst = getattr(models, name), getattr(copy, name)
        assert dst is not src
        assert all(t.device.type == "meta" for t in dst.buffers())
        assert all(t.device.type == "cpu" for t in src.buffers())
    assert copy.anchors.device.type == "meta"


@pytest.mark.parametrize("n", [8, 4])
def test_data_parallel_matches_the_single_program_and_jax(setup, n):
    """``data_parallel`` over ``[cpu] * n`` on a batch of 8 equals the
    unsharded program within the JAX test's 1e-5 and JAX's
    ``data_parallel`` over its 8-device mesh within the pipeline
    tolerances; it takes lists of shards, and refuses a wrong count."""
    _, models, jmodels = setup
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (8, H, W, 3)).astype(np.float32)
    program = build_pipeline_program(models, H, W, STANDARD,
                                     max_faces=2, num_candidates=32)
    mesh = (CPU,) * n
    weights = sharding.shard_params(models, mesh)
    step = sharding.data_parallel(
        lambda d: build_pipeline_program(weights[d], H, W, STANDARD,
                                         max_faces=2, num_candidates=32),
        mesh)
    with torch.inference_mode():
        single = program(torch.from_numpy(images))
        shards = step(torch.from_numpy(images))
        again = step(sharding.shard_batch(torch.from_numpy(images), mesh))
    assert len(shards) == n
    for k in single:
        got = torch.cat([s[k] for s in shards]).numpy()
        np.testing.assert_allclose(got, single[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
        assert np.array_equal(got, torch.cat([s[k] for s in again]).numpy())
    with pytest.raises(TypeError, match="batch argument"):
        step(torch.from_numpy(images), torch.from_numpy(images))
    with pytest.raises(ValueError, match="shards"):
        step([torch.from_numpy(images)])
    jprog = j_programs.build_pipeline_program(
        jmodels, H, W, JMode.STANDARD, max_faces=2, num_candidates=32)
    jmesh = j_sharding.make_mesh()
    jout = j_sharding.data_parallel(jprog, jmesh)(
        j_sharding.shard_params(jmodels.params, jmesh),
        j_sharding.shard_batch(jnp.asarray(images), jmesh))
    got = {k: torch.cat([s[k] for s in shards]).numpy() for k in single}
    np.testing.assert_array_equal(got["valid"], np.asarray(jout["valid"]))
    for k in ("boxes", "raw_keypoints"):
        assert np.abs(got[k] - np.asarray(jout[k])).max() <= 1e-4, k
    for k in ("scores", "mesh_scores"):
        assert np.abs(got[k] - np.asarray(jout[k])).max() <= 1e-5, k
    assert np.abs(got["mesh"] - np.asarray(jout["mesh"])).max() <= \
        _tol(np.asarray(jout["mesh"]))


# -- FaceDetector(data_parallel=True) --------------------------------------


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "full"])
@pytest.mark.parametrize("mode", [FAST, STANDARD, FULL],
                         ids=lambda m: m.name)
def test_data_parallel_detector_matches_single_and_jax(
        setup, mesh_of, jax_detector, mode, adaptive):
    """An 8-entry mesh and a batch of 3 (padded to 8, one row a shard):
    the port's sharded faces equal its unsharded ones within the JAX
    bounds, and JAX's ``data_parallel=True`` detector's within the
    pipeline tolerances (and the JAX bounds on boxes and scores)."""
    frames, models, jmodels = setup
    batch = np.concatenate([frames, frames[:1, :, ::-1]])
    single = _detector(models, adaptive=adaptive)
    mesh_of(8)
    dp = _detector(models, adaptive=adaptive, data_parallel=True)
    assert dp._mesh == (CPU,) * 8 and dp._batch_pad_target(3) == 8
    got = dp.detect_faces_batch(batch, mode)
    want = single.detect_faces_batch(batch, mode)
    assert sum(len(f) for f in got) >= 3
    _within_jax_bounds(got, want)
    jdet = jax_detector(jmodels, adaptive=adaptive, data_parallel=True)
    assert jdet._mesh is not None and jdet._mesh.devices.size == 8
    ref = jdet.detect_faces_batch(batch, JMode(mode.value))
    _match_jax(got, ref, mode)
    _within_jax_bounds(got, ref)
    if adaptive and mode != FAST:
        # The sticky bucket is the largest face count over the shards,
        # and the next batch runs without an overflow re-run.
        assert dp._speculation_bucket(H, W, mode) >= max(map(len, got))
        dp.timings.reset()
        _bit_equal(dp.detect_faces_batch(batch, mode), got)
        assert not any(k.startswith("face_stages")
                       for k in dp.timings.report())


def test_data_parallel_stream_bucketing_and_refusals(setup, mesh_of):
    """The stream pads and shards as the batch call does; bucketed images
    pad, then shard; one visible device makes no mesh; a mesh refuses
    device pinning and replica pools, with the JAX messages."""
    frames, models, _ = setup
    mesh_of(1)
    assert _detector(models, data_parallel=True)._mesh is None
    mesh_of(4)
    det = _detector(models, data_parallel=True, adaptive=False)
    batch = np.concatenate([frames, frames[:1]])
    direct = det.detect_faces_batch(batch, FAST)
    streamed = list(det.detect_faces_batch_stream([batch, batch], FAST,
                                                  depth=2))
    assert len(streamed) == 2
    for s in streamed:
        _bit_equal(s, direct)
    bucketed = _detector(models, data_parallel=True, bucket_images=True)
    out = bucketed.detect_faces_batch(np.stack([frames[0][:80, :120]] * 5),
                                      FAST)
    assert len(out) == 5
    with pytest.raises(ValueError, match="device-pinned dispatch"):
        det._stream_dispatch(batch, FAST, device="cpu")
    with pytest.raises(ValueError, match="data_parallel"):
        ReplicaPool(det, devices=["cpu"])
    # The warm-up's overflow re-run runs sharded at the padded batch.
    bucketed.warmup((H, W, 3), batch_size=3, modes=[STANDARD])
    assert (256, 256, STANDARD, "stage") in bucketed._programs.keys()


# -- ReplicaPool -----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_replica_pool_matches_the_detector_and_jax(setup, jax_detector, k):
    """A pool of ``k`` replicas over ``[cpu] * k``: each whole batch's
    faces equal the same detector's ``detect_faces_batch`` bit for bit,
    and JAX's pool over ``k`` devices within the pipeline tolerances."""
    frames, models, jmodels = setup
    batches = _batches(frames, 4)
    det = _detector(models)
    want = [det.detect_faces_batch(b, STANDARD) for b in batches]
    with ReplicaPool(det, devices=["cpu"] * k, mode=STANDARD) as pool:
        assert pool.num_replicas == k
        got = pool.map_batches(batches)
        stats = pool.stats
    for g, w in zip(got, want):
        _bit_equal(g, w)
    assert [s["accepted"] for s in stats] == \
        [len(range(i, 4, k)) for i in range(k)]
    assert list(det._replica_params_cache) == [CPU]
    jdet = jax_detector(jmodels)
    with JReplicaPool(jdet, devices=jax.devices()[:k],
                      mode=JMode.STANDARD) as jpool:
        ref = jpool.map_batches(batches)
    for g, r in zip(got, ref):
        _match_jax(g, r, STANDARD)


def test_replica_pool_full_mode_and_overflow(setup):
    """FULL through two replicas on a fresh detector: the first batch
    overflows the one-face speculation and re-runs its face stages on the
    replica's networks; every batch equals the detector's own call."""
    frames, models, _ = setup
    batches = _batches(frames, 3)
    det = _detector(models)
    with ReplicaPool(det, devices=["cpu", "cpu"], mode=FULL) as pool:
        got = pool.map_batches(batches)
    assert sum(n for key, n in det.timings.calls.items()
               if key.startswith("face_stages[")) >= 1
    for g, b in zip(got, batches):
        _bit_equal(g, det.detect_faces_batch(b, FULL))


def test_replica_pool_defaults_to_the_visible_devices(setup, mesh_of):
    frames, models, _ = setup
    mesh_of(3)
    det = _detector(models)
    with ReplicaPool(det, mode=FAST) as pool:
        assert pool.num_replicas == 3
        outs = [pool.submit(frames[:1]) for _ in range(6)]
        assert all(len(f.result(timeout=60)) == 1 for f in outs)
        assert [s["accepted"] for s in pool.stats] == [2, 2, 2]
        assert [s["device"] for s in pool.stats] == ["cpu"] * 3


class _StubPipe:
    """A replica's pipeline that is full or not and resolves at once."""

    def __init__(self, full):
        self.full = full
        self.accepted = self.forced = 0

    def _done(self, images):
        f = Future()
        f.set_result([[] for _ in range(len(images))])
        return f

    def try_submit(self, images, orig_sizes=None):
        if self.full:
            return None
        self.accepted += 1
        return self._done(images)

    def submit(self, images, orig_sizes=None):
        self.forced += 1
        return self._done(images)

    def close(self, wait=True):
        pass


def test_full_queue_fails_over_to_the_next_replica(setup):
    """As the JAX test: submits pass over a full queue to the next
    replica; only when every queue is full does one block, on the
    round-robin pick; the counters show the imbalance."""
    _, models, _ = setup
    pool = ReplicaPool(_detector(models), devices=["cpu", "cpu"])
    stuck, healthy = _StubPipe(full=True), _StubPipe(full=False)
    pool._pipes = [stuck, healthy]
    batch = np.zeros((1, 16, 16, 3), np.uint8)
    try:
        for _ in range(4):
            assert pool.submit(batch).result(timeout=10) == [[]]
        assert healthy.accepted == 4
        assert stuck.accepted == 0 and stuck.forced == 0
        healthy.full = True
        assert pool.submit(batch).result(timeout=10) == [[]]
        assert stuck.forced + healthy.forced == 1
        stats = pool.stats
        assert [s["accepted"] for s in stats] == [1, 4]
        assert stats[0]["skipped_full"] >= 2
    finally:
        pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(batch)


def test_encoded_bytes_decode_once_across_a_failover(setup, monkeypatch):
    """A list of encoded images is decoded once on the caller's thread,
    even when the submit passes over a full replica; the faces are those
    of the decoded batch."""
    frames, models, _ = setup
    det = _detector(models)
    pool = ReplicaPool(det, devices=["cpu", "cpu"], mode=STANDARD)
    calls = []
    decode = t_replica.decode_images
    monkeypatch.setattr(t_replica, "decode_images",
                        lambda datas: calls.append(len(datas))
                        or decode(datas))
    real = pool._pipes[1]
    pool._pipes[0] = _StubPipe(full=True)
    try:
        pngs = [_png(f) for f in frames]
        got = pool.submit(pngs).result(timeout=120)
    finally:
        pool._pipes[0] = real
        pool.close()
    assert calls == [len(frames)]
    _bit_equal(got, det.detect_faces_batch(frames, STANDARD))


def test_pool_concurrency_and_close(setup):
    """Four replicas each inside a dispatch at once (a barrier they all
    must reach), six submitting threads whose 30 batches all resolve, and
    a submit after close raises."""
    frames, models, _ = setup
    det = _detector(models)
    n = 4
    barrier = threading.Barrier(n, timeout=60)
    orig = det._stream_dispatch

    def gated(raw, mode, orig_sizes=None, **kw):
        barrier.wait()
        return orig(raw, mode, orig_sizes, **kw)

    det._stream_dispatch = gated
    try:
        with ReplicaPool(det, devices=["cpu"] * n, mode=FAST) as pool:
            futs = [pool.submit(frames[:1]) for _ in range(n)]
            outs = [f.result(timeout=120) for f in futs]
    finally:
        del det._stream_dispatch
    assert all(len(o) == 1 for o in outs)
    pool = ReplicaPool(det, devices=["cpu"] * n, mode=FAST)
    futs, lock = [], threading.Lock()

    def submitter():
        for _ in range(5):
            f = pool.submit(frames[:1])
            with lock:
                futs.append(f)

    threads = [threading.Thread(target=submitter) for _ in range(6)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # thread switches inside the counters
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not any(t.is_alive() for t in threads)
        assert len(futs) == 30
        assert all(len(f.result(timeout=120)) == 1 for f in futs)
        assert sum(s["accepted"] for s in pool.stats) == 30
    finally:
        pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(frames[:1])


def test_pinned_pipeline_takes_a_list_of_frames(setup):
    frames, models, _ = setup
    det = _detector(models)
    with ServingPipeline(det, FAST, device="cpu") as pipe:
        out = pipe.submit([frames[0], frames[1]]).result(timeout=60)
    _bit_equal(out, det.detect_faces_batch(frames, FAST))


# -- the stream, warm-up and the replica cache -----------------------------


def test_batch_stream_rotates_over_devices(setup):
    """``detect_faces_batch_stream(devices=)`` rotates the batches over
    the replicas and yields the single-device stream's faces in order."""
    frames, models, _ = setup
    batches = _batches(frames, 5)
    det = _detector(models)
    ref = list(det.detect_faces_batch_stream(batches, STANDARD))
    seen = []
    orig = det._stream_dispatch

    def spy(raw, mode, orig_sizes=None, **kw):
        seen.append(kw.get("device"))
        return orig(raw, mode, orig_sizes, **kw)

    det._stream_dispatch = spy
    got = list(det.detect_faces_batch_stream(batches, STANDARD,
                                             devices=["cpu"] * 3))
    del det._stream_dispatch
    assert seen == [CPU] * 5 and len(got) == 5
    for g, r in zip(got, ref):
        _bit_equal(g, r)


def test_warmup_devices_builds_the_replicas(setup):
    _, models, _ = setup
    det = _detector(models)
    det.warmup((64, 64, 3), modes=[FAST], devices=["cpu"])
    assert list(det._replica_params_cache) == [CPU]
    det.dispose()
    assert not det._replica_params_cache


def test_replica_params_after_dispose_and_memory_report(setup):
    """``_replica_params`` raises after ``dispose``; ``memory_report``
    counts the replicas and their weights as the JAX detector does."""
    _, models, _ = setup
    det = _detector(models)
    assert "replica_copies" not in det.memory_report()
    assert det._replica_params("cpu") is det.models
    rep = det.memory_report()
    one = rep["total_weights"]
    assert rep["replica_copies"] == 1
    assert rep["replica_weights"] == one * rep["replica_copies"]
    det.dispose()
    with pytest.raises(RuntimeError, match="dispose"):
        det._replica_params("cpu")


# -- segmentation on its own device ----------------------------------------


def test_seg_device_and_place_on(mesh_of):
    """``seg_device="auto"`` takes the second visible device (None with
    one); the segmenter placed there gives the combined calls' masks and
    faces of the unplaced detector; ``place_on`` copies the network and
    leaves the one passed in where it was."""
    frames, models, _, _ = small_pipeline(segmenter="general")
    mesh_of(1)
    assert _detector(models, seg_device="auto")._seg_device is None
    mesh_of(2)
    det = _detector(models, seg_device="auto", with_segmentation=True)
    plain = _detector(models, with_segmentation=True)
    assert det._seg_device == CPU
    assert det.accelerator_report["segmentation"] == "cpu#0"
    assert plain.accelerator_report["segmentation"] == "cpu"
    got = det.detect_faces_with_segmentation_batch(frames)
    want = plain.detect_faces_with_segmentation_batch(frames)
    for (gf, gm), (wf, wm) in zip(got, want):
        _bit_equal([gf], [wf])
        assert np.array_equal(gm.data, wm.data)
    seg = det._segmentation
    seg.place_on("meta")
    assert seg.device.type == "meta"
    assert all(t.device.type == "meta" for t in seg.model.buffers())
    assert all(t.device.type == "cpu"
               for t in models.segmentation.buffers())
    seg.dispose()
    with pytest.raises(RuntimeError, match="disposed"):
        seg.place_on("cpu")


# -- process_video(devices=) -----------------------------------------------


def test_process_video_over_replicas_matches_jax(clip,  # noqa: F811
                                                 jax_detector):
    """``detect_faces_from_video(devices=[cpu, cpu])`` on the tracking
    tests' seeded clip: the frames, faces and IDs of the run without
    replicas, and of the JAX package's ``process_video`` over two
    devices (faces within the pipeline tolerances, IDs equal)."""
    path, decoded = clip
    _, models, jmodels = small_pipeline(frames=decoded)
    det = _detector(models, enable_tracking=True)
    want = list(det.detect_faces_from_video(path, STANDARD, batch_size=3))
    det.reset_tracking()
    got = list(det.detect_faces_from_video(path, STANDARD, batch_size=3,
                                           devices=["cpu", "cpu"]))
    assert [(r.frame_index, r.timestamp_s) for r in got] == \
        [(r.frame_index, r.timestamp_s) for r in want]
    _bit_equal([r.faces for r in got], [r.faces for r in want])
    ids = [[f.tracking_id for f in r.faces] for r in got]
    assert ids == [[f.tracking_id for f in r.faces] for r in want]
    assert sum(map(len, ids)) >= len(got)
    jdet = jax_detector(jmodels, enable_tracking=True)
    ref = list(j_video.process_video(jdet, path, JMode.STANDARD,
                                     batch_size=3,
                                     devices=jax.devices()[:2]))
    assert [(r.frame_index, r.timestamp_s) for r in got] == \
        [(r.frame_index, r.timestamp_s) for r in ref]
    _match_jax([r.faces for r in got], [r.faces for r in ref], STANDARD)
    assert ids == [[f.tracking_id for f in r.faces] for r in ref]


# -- FaceServer(devices=) --------------------------------------------------


def test_server_replicas_detect_and_info(setup, jax_detector):
    """``FaceServer(devices=[cpu, cpu])``: ``/v1/detect`` answers with the
    faces of ``detect_faces_batch`` through a two-replica pool, and
    ``/v1/info`` reports the replicas' devices and counters in the JAX
    server's form."""
    frames, models, jmodels = setup
    det = _detector(models)
    srv = FaceServer(det, devices=["cpu", "cpu"], batch_window_ms=1.0,
                     max_batch=1).start()
    try:
        for f in frames:
            status, payload, _ = _post(
                f"{srv.address}/v1/detect?mode=full&mesh=1&iris=1", _png(f))
            assert status == 200
            _assert_faces_match([payload["faces"]],
                                det.detect_faces_batch(f[None], FULL))
        status, body = _get(f"{srv.address}/v1/info")
    finally:
        srv.close()
    info = json.loads(body)
    assert status == 200 and info["replica_devices"] == ["cpu", "cpu"]
    stats = info["replica_stats"]["FaceDetectionMode.FULL"]
    assert [s["device"] for s in stats] == ["cpu", "cpu"]
    assert sum(s["accepted"] for s in stats) == len(frames)
    jsrv = j_server.FaceServer(jax_detector(jmodels),
                               devices=jax.devices()[:2])
    jsrv._executor_for_mode(JMode.FULL)
    jinfo = jsrv._do_info()[1]
    jsrv.close()
    assert len(jinfo["replica_devices"]) == len(info["replica_devices"])
    (jstats,) = jinfo["replica_stats"].values()
    assert [set(s) for s in jstats] == [set(s) for s in stats]
    assert info["memory_report"]["replica_copies"] == 1
