"""Captured programs of the models and of the readback, on the CPU.

``tests/test_torch_graphs.py`` holds the detector's captured programs;
this file holds the other programs captured per key in the same way
(``pipeline/graphs.py``): ``SelfieSegmentation`` per image size,
``FaceEmbedding.embed_batch`` per image size and power-of-two slab, the
three single-network classes per input signature, and the readback pack
folded into each detector program.  As there, the one seam,
``graphs.graph_maker``, is replaced by the stand-in whose replays re-run
the program into the same static outputs; each replay is held bit for bit
against the eager program (run inside ``graphs.eager``) and within the
existing budgets against the JAX package.  The real graphs are checked on
the card by phase 14 of ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch

from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
from face_detection_tflite_torch.kernels import build as _build
from face_detection_tflite_torch.models import embedding as te
from face_detection_tflite_torch.models import segmentation as t_seg
from face_detection_tflite_torch.models.standalone import (
    FaceBlendshapesModel, FaceLandmark, IrisLandmark)
from face_detection_tflite_torch.ops import warp
from face_detection_tflite_torch.parallel import sharding
from face_detection_tflite_torch.pipeline import graphs, readback
from face_detection_tflite_torch.pipeline.programs import \
    build_pipeline_program
from face_detection_tflite_tpu.models import embedding as je
from face_detection_tflite_tpu.models import segmentation as j_seg

from .test_torch_embedding import _FRAME, _PAIRS
from .test_torch_graphs import StandIn, _payload
from .test_torch_segmentation import _assert_masks_match, _setup, _ties
from .torch_parity import H, MAX_FACES, W, small_pipeline

FULL = FaceDetectionMode.FULL
CPU = torch.device("cpu")


@pytest.fixture
def stand_in(monkeypatch):
    maker = StandIn()
    monkeypatch.setattr(graphs, "graph_maker", lambda device: maker)
    return maker


@pytest.fixture(scope="module")
def setup():
    return small_pipeline()


def _masks_equal(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
        if isinstance(w, t_seg.MulticlassSegmentationMask):
            np.testing.assert_array_equal(g.class_data, w.class_data)


# -- SelfieSegmentation -------------------------------------------------------


@pytest.mark.parametrize("mask_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("kind", ["general", "multiclass"])
def test_segmentation_replays_match_eager_and_jax(stand_in, kind,
                                                  mask_dtype):
    """One program per image size, captured (under ``capture_now``) at
    its first call: the replays' masks equal the eager program's bit for
    bit, and the JAX
    package's within ``test_torch_segmentation``'s budgets (float32 within
    1e-5, uint8 equal away from .5 ties)."""
    frames, models, _, jseg = _setup(kind)
    multiclass = kind == "multiclass"
    seg = t_seg.SelfieSegmentation(models.segmentation, multiclass,
                                   mask_dtype=mask_dtype, device="cpu")
    other = np.ascontiguousarray(frames[::-1, ::-1])
    for i, batch in enumerate((frames, other, frames)):
        with graphs.capture_now() if i == 0 else contextlib.nullcontext():
            got = seg(batch)
        with graphs.eager():
            want = seg(batch)
        _masks_equal(got, want)
    assert stand_in.captures == 1 and stand_in.replays == 2
    (prog,) = seg._programs.captured()
    assert isinstance(prog, graphs.CapturedProgram)
    ref = j_seg.SelfieSegmentation(jseg, multiclass, mask_dtype=mask_dtype)(
        frames)
    if mask_dtype == "float32":
        _assert_masks_match(got, ref)
        return
    floats = t_seg.SelfieSegmentation(models.segmentation, multiclass,
                                      device="cpu")(frames)
    for g, w, f in zip(got, ref, floats):
        for a, b, p in ((g.data, w.data, f.data),) + (
                ((g.class_data, w.class_data, f.class_data),)
                if multiclass else ()):
            assert not ((a != b) & ~_ties(p)).any()
    _assert_masks_match(got, ref, uint8=True)


def test_segmentation_keys_and_release(stand_in):
    """Two image sizes give two keys; ``place_on`` another device and
    ``dispose`` release the graphs (a program runs the network copy it
    closed over), and later calls raise after ``dispose``."""
    frames, models, _, _ = _setup("general")
    seg = t_seg.SelfieSegmentation(models.segmentation, device="cpu")
    small = np.ascontiguousarray(frames[:, :80, :128])
    with graphs.capture_now():                     # each size's first call
        for batch in (frames, small, frames, small):
            seg(batch)
    assert sorted(seg._programs.keys()) == [(80, 128), (H, W)]
    assert stand_in.captures == 2 and stand_in.replays == 2
    progs = seg._programs.captured()
    assert len(progs) == 2
    seg.place_on("meta")
    assert not seg._programs.keys() and all(not p.keys() for p in progs)
    assert seg.device.type == "meta"

    seg = t_seg.SelfieSegmentation(models.segmentation, device="cpu")
    with graphs.capture_now():
        seg(frames)
    seg(frames)
    progs = seg._programs.captured()
    assert progs[0].keys()
    seg.dispose()
    assert not seg._programs.keys() and all(not p.keys() for p in progs)
    with pytest.raises(RuntimeError, match="disposed"):
        seg(frames)


def test_segmentation_and_detector_replay_from_two_threads(stand_in):
    """A segmentation replay and a detector replay from two threads go
    through one graph pool, whose lock orders them: each thread's results
    equal the sequential calls'."""
    frames, models, _, _ = _setup("general")
    seg = t_seg.SelfieSegmentation(models.segmentation, device="cpu")
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES)
    with graphs.capture_now():
        want_masks = seg(frames)                   # eager, then captured
        for _ in range(2):  # the 1-face slab and its re-run, then slab 16
            want_faces = _payload(det.detect_faces_batch(frames))
    replays = stand_in.replays
    (sprog,) = seg._programs.captured()
    assert sprog.pool is det._programs.captured()[0].pool is \
        graphs.pool_for(CPU)
    errors = []

    def masks():
        for _ in range(4):
            try:
                _masks_equal(seg(frames), want_masks)
            except AssertionError as e:
                errors.append(f"masks: {e}")

    def faces():
        for _ in range(4):
            if _payload(det.detect_faces_batch(frames)) != want_faces:
                errors.append("faces differ")

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=f) for f in (masks, faces)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert stand_in.replays - replays == 8


# -- FaceEmbedding.embed_batch ------------------------------------------------


def test_embed_batch_pads_to_a_power_of_two_slab(stand_in, monkeypatch):
    """N = 3 pads to a slab of 4 and shares its one capture with N = 4;
    the replays equal the eager calls bit for bit and the JAX
    ``embed_batch`` within ``test_torch_embedding``'s 1e-5.  K2's launch
    at 112 px is counted once a call: by the wrapper on the eager first
    call, from the capture's tally at each replay."""
    real = warp.warp_normalize

    def counting(frames, *args, out_size, **kw):
        _build.count_launch(real, out_size)
        return real(frames, *args, out_size=out_size, **kw)

    monkeypatch.setattr(warp, "warp_normalize", counting)
    monkeypatch.setattr(real, "launches_by_size", {})
    mine = te.FaceEmbedding(te.build_mobilefacenet(0), allow_untrained=True,
                            device="cpu")
    pairs = _PAIRS + [((50.0, 60.0), (80.0, 75.0))]
    four = pairs + [((150.0, 40.0), (190.0, 44.0))]
    with graphs.capture_now():
        got3 = mine.embed_batch(_FRAME, pairs)         # eager, then captured
    got4 = mine.embed_batch(_FRAME, four)
    again = mine.embed_batch(_FRAME, pairs)
    assert stand_in.captures == 1 and stand_in.replays == 2
    (prog,) = mine._programs.captured()
    assert [k[1][0] for k in prog.keys()] == [(1, 4)]
    assert real.launches_by_size == {112: 3}
    with graphs.eager():
        want3 = mine.embed_batch(_FRAME, pairs)
        want4 = mine.embed_batch(_FRAME, four)
    assert got3.shape == (3, 192) and got4.shape == (4, 192)
    np.testing.assert_array_equal(again, want3)
    np.testing.assert_array_equal(got4, want4)
    np.testing.assert_array_equal(got3, want3)
    np.testing.assert_array_equal(got4[:3], got3)   # rows of one slab
    ref = je.FaceEmbedding(je.build_mobilefacenet(0), allow_untrained=True
                           ).embed_batch(_FRAME, pairs)
    assert np.abs(again - ref).max() <= 1e-5
    mine.embed_batch(_FRAME, pairs[:1])               # slab 1: a new key
    assert [k[1][0] for k in prog.keys()] == [(1, 4)]
    assert [(k[1][0], n) for k, n in prog.pending().items()] == [((1, 1), 1)]
    with graphs.capture_now():                        # counted once before
        mine.embed_batch(_FRAME, pairs[:1])
    assert sorted(k[1][0] for k in prog.keys()) == [(1, 1), (1, 4)]
    mine.dispose()
    assert not mine._programs.keys() and not prog.keys()
    with pytest.raises(RuntimeError, match="disposed"):
        mine.embed_batch(_FRAME, pairs)


# -- the three single-network classes -----------------------------------------


def test_single_network_classes_replay_and_release(setup, stand_in):
    """``FaceLandmark``, ``IrisLandmark`` and ``FaceBlendshapesModel`` keep
    one program each, captured per input signature: the replays equal the
    eager calls bit for bit, a float crop is a key of its own, and
    ``dispose`` releases the graphs."""
    _, models, _ = setup
    rng = np.random.default_rng(5)
    face = rng.integers(0, 256, (192, 192, 3), dtype=np.uint8)
    eye = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    pts = rng.uniform(0.0, 256.0, (146, 2)).astype(np.float32)
    mesh = FaceLandmark(model=models.mesh, device="cpu")
    iris = IrisLandmark(model=models.iris, device="cpu")
    bs = FaceBlendshapesModel(model=models.blendshapes, device="cpu")
    calls = (
        (mesh, lambda x: mesh.call_with_score(x), (face, face[::-1])),
        (iris, iris, (eye, eye[:, ::-1])),
        (bs, bs, (pts, pts[::-1] * 0.5)))
    for net, call, inputs in calls:
        for i, x in enumerate(inputs + inputs):
            with graphs.capture_now() if i == 0 else \
                    contextlib.nullcontext():
                got = call(x)
            with graphs.eager():
                want = call(x)
            if isinstance(want, tuple):
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] == want[1]
            else:
                np.testing.assert_array_equal(got, want)
    assert stand_in.captures == 3 and stand_in.replays == 9
    lm, score = mesh.call_with_score(face.astype(np.float32))
    assert stand_in.captures == 3                  # a new key, eager
    with graphs.capture_now():
        assert mesh.call_with_score(face.astype(np.float32))[1] == score
    assert stand_in.captures == 4
    np.testing.assert_array_equal(lm, mesh.call_with_score(face)[0])
    for net, _, _ in calls:
        (prog,) = net._programs.captured()
        assert isinstance(prog, graphs.CapturedProgram) and prog.keys()
        net.dispose()
        assert not net._programs.keys() and not prog.keys()
    with pytest.raises(RuntimeError, match="disposed"):
        iris(eye)


# -- the readback pack inside each detector program ---------------------------


def _assert_readback(det, got, want, rows, scale) -> None:
    """``got`` (``readback.fetch_finish``'s arrays) equals, bit for bit,
    the first ``rows`` rows of the raw program outputs ``want`` as the
    readback encodes them: every output but the device-resident ``det_*`` slab
    (``det_count`` read back), the mesh and iris rounded to int16 at
    ``scale`` px^-1 where it is given."""
    keys = {k for k in want if k == "det_count" or not k.startswith("det_")}
    assert set(got) == keys
    for k in keys:
        a = want[k][:rows].numpy()
        if scale and k in ("mesh", "iris"):
            a = (np.clip(np.round(a * np.float32(scale)), -32767, 32767)
                 .astype(np.int16).astype(np.float32) / scale)
        assert got[k].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k], a, k)


def _kw(det) -> dict:
    """The detector's program options, for ``build_pipeline_program``."""
    return {"max_faces": MAX_FACES, "min_score": det.min_score,
            "num_candidates": det.num_candidates,
            "min_face_size": 0.0 if det.bucket_images else det.min_face_size}


@pytest.mark.parametrize("quantized", [False, True])
def test_folded_pack_reads_back_the_eager_outputs(setup, stand_in,
                                                  quantized):
    """The speculative program and the overflow re-run pack their own
    readback: on a batch of 3 padded to 4, ``readback.fetch`` of a replay
    gives the first 3 rows of ``build_pipeline_program``'s eager outputs
    bit for bit (fp32 or int16 landmarks), the same arrays as the eager
    program's own pack, and the ``det_*`` slab stays on the device."""
    frames, models, _ = setup
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                       quantized_readback=quantized)
    scale = det._readback_scale(H, W)
    assert (scale is not None) == quantized
    images, b, _ = det._prepare_batch(frames[[0, 1, 0]])
    assert (b, images.shape[0]) == (3, 4)
    slab = ("det_boxes", "det_raw_keypoints", "det_scores", "det_valid")
    with torch.inference_mode():
        prog = det._program(H, W, FULL, face_slab=2)
        with graphs.capture_now():
            prog(images)                           # eager, then captured
        out = prog(images)
        want = build_pipeline_program(models, H, W, FULL, face_slab=2,
                                      **_kw(det))(images)
        with graphs.eager():
            eager = readback.fetch(prog(images), b)
        got = readback.fetch(out, b)
        _assert_readback(det, got, want, b, scale)
        for k in got:
            np.testing.assert_array_equal(got[k], eager[k], k)
        assert sorted(k for k in out if k.startswith("det_")) == sorted(slab)
        for k in slab:
            assert torch.equal(out[k], want[k])
        assert (got["det_count"] > 2).any()

        prefix = [out[k][:, :MAX_FACES] for k in slab]
        stage = det._face_stage_program(H, W, FULL)
        with graphs.capture_now():
            stage(images, *prefix)                 # eager, then captured
        out2 = stage(images, *prefix)
        want2 = build_pipeline_program(models, H, W, FULL,
                                       from_detections=True)(images, *prefix)
        _assert_readback(det, readback.fetch(out2, b), want2, b, scale)
        assert set(out2) == {"packed", "layout"}
    assert stand_in.captures == 2 and stand_in.replays == 2
    assert det.memory_report()["compiled_programs"] == 2


@pytest.mark.parametrize("quantized", [False, True])
def test_folded_pack_over_two_shards(setup, stand_in, monkeypatch,
                                     quantized):
    """Each data-parallel shard's program packs its own readback; the
    fetch trims the pad rows shard by shard and skips a shard of pad rows
    only, and the arrays equal the eager program's rows of each shard bit
    for bit."""
    frames, models, _ = setup
    monkeypatch.setattr(sharding, "visible_devices",
                        lambda kind="cuda": [CPU, CPU])
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                       data_parallel=True, adaptive=False,
                       quantized_readback=quantized)
    scale = det._readback_scale(H, W)
    for rows, padded, fetched in (([0, 1, 0], 4, 2), ([1], 2, 1)):
        images, b, _ = det._prepare_batch(frames[rows])
        assert (b, images.shape[0]) == (len(rows), padded)
        with torch.inference_mode():
            prog = det._program(H, W, FULL)
            with graphs.capture_now():
                prog(images)
            outs = prog(images)
            assert isinstance(outs, list) and len(outs) == 2
            handle = readback.fetch_async(outs, b)
            assert len(handle) == fetched
            # Each shard's own eager program: a network's batch of 2 and of
            # 4 may round differently.
            fn = build_pipeline_program(models, H, W, FULL, **_kw(det))
            parts = [fn(x) for x in images.chunk(2)]
            want = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        _assert_readback(det, readback.fetch_finish(handle), want, b, scale)
    assert len(det._programs.captured()) == 1 and stand_in.captures == 2


def test_folded_pack_through_the_entry_point(setup, stand_in):
    """End to end through ``detect_faces_batch`` with the int16 readback:
    a batch of 3 padded to 4 whose frames overflow the one-face slab, so
    that every replay re-runs its face stages; the faces equal the eager
    detector's bit for bit."""
    frames, models, _ = setup
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES)
    ref = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES)
    for d in (det, ref):
        d._speculation_bucket = lambda h, w, mode: 1
        d._note_face_count = lambda h, w, mode, n: None
    batch = frames[[0, 1, 0]]
    for i in range(3):
        with graphs.capture_now() if i == 0 else contextlib.nullcontext():
            got = det.detect_faces_batch(batch)
        with graphs.eager():
            want = ref.detect_faces_batch(batch)
        assert json.dumps(_payload(got)) == json.dumps(_payload(want))
        assert max(len(f) for f in got) > 1
    assert stand_in.captures == 2 and stand_in.replays == 4
