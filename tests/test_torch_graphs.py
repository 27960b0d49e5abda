"""Captured programs (``pipeline/graphs.py``) on the CPU.

A CUDA graph cannot be captured on the CPU, so these tests replace the one
seam, ``graphs.graph_maker``, with a stand-in: its capture runs the program
once on the static inputs, and each replay re-runs it into the same static
output tensors, so that results alias as a real graph's do.  On the small
seeded pipeline of ``tests/torch_parity.py`` the detector's captured
programs are held bit for bit against its eager programs (run inside
``graphs.eager``) and within the existing budgets against the JAX
package's programs.  The real graphs are checked on the card by phase 14
of ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import json
import time
import types

import numpy as np
import pytest
import torch

from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
from face_detection_tflite_torch.kernels import build as _build
from face_detection_tflite_torch.models.standalone import FaceDetection
from face_detection_tflite_torch.parallel import sharding
from face_detection_tflite_torch.pipeline import graphs, readback, timings
from face_detection_tflite_torch.pipeline.config import FaceDetectionModel

from .test_torch_full import _assert_full_match, _jax_full
from .test_torch_pipeline import _assert_slabs_match, _jax_slab
from .torch_parity import H, MAX_FACES, W, small_pipeline

FULL, STANDARD = FaceDetectionMode.FULL, FaceDetectionMode.STANDARD
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    frames, models, jmodels = small_pipeline()
    # A second pair of frames: the first two with their order and rows
    # changed, so that the two batches' faces differ.
    other = np.ascontiguousarray(frames[::-1, ::-1])
    return frames, other, models, jmodels


def _leaves(tree) -> list:
    """The tensors of a pytree of dicts, lists and tuples, in order (a
    leaf that is no tensor, such as a readback layout, is left out)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class StandIn:
    """The stand-in graph maker: counts captures and replays, and reports
    its capture's parts as the CUDA graph maker does (the host run timed,
    the pool's parts 0)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def __call__(self, fn, static, pool):
        self.captures += 1
        t0 = time.perf_counter()
        out = fn(*static)
        parts = {"adopt_s": 0.0, "renewed": False,
                 "run_s": time.perf_counter() - t0, "end_s": 0.0,
                 "pool_bytes": 0}

        def replay():
            self.replays += 1
            # A real replay enters no kernel wrapper: its launches are the
            # captured tally's, which CapturedProgram adds.
            with _build.tally_launches():
                new = fn(*static)
            for s, n in zip(_leaves(out), _leaves(new)):
                s.copy_(n)
        return replay, out, parts


@pytest.fixture
def stand_in(monkeypatch):
    maker = StandIn()
    monkeypatch.setattr(graphs, "graph_maker", lambda device: maker)
    return maker


def _detector(models, **kw):
    return FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                        **kw)


def _one_face_bucket(det):
    """Pins the speculative slab to 1, so that every batch with more than
    one face takes the overflow re-run on the dispatch's ``det_*`` slab."""
    det._speculation_bucket = lambda h, w, mode: 1
    det._note_face_count = lambda h, w, mode, n: None
    return det


def _payload(faces):
    return json.dumps([[f.to_dict(include_mesh=True, include_iris=True)
                        for f in per] for per in faces])


@pytest.mark.parametrize("mode", [STANDARD, FULL])
def test_captured_detector_matches_eager_and_jax(setup, stand_in, mode):
    """Replayed calls give the eager detector's faces bit for bit, with an
    overflow re-run on every batch (the main program and the face-stage
    program both replayed), and the replayed speculative slab is the JAX
    program's within the existing budgets."""
    frames, other, models, jmodels = setup
    det = _one_face_bucket(_detector(models))
    ref = _one_face_bucket(_detector(models))
    for i, batch in enumerate((frames, other, frames, other)):
        with graphs.capture_now() if i == 0 else contextlib.nullcontext():
            got = det.detect_faces_batch(batch, mode)
        with graphs.eager():
            want = ref.detect_faces_batch(batch, mode)
        assert _payload(got) == _payload(want)
        assert max(len(f) for f in got) > 1  # the re-run ran
    # Two programs a batch: each captured on the first batch (under
    # capture_now) and replayed on the three batches after it.
    assert stand_in.captures == 2 and stand_in.replays == 6
    assert det.memory_report()["compiled_programs"] == 2
    # The JAX program's outputs are fp32: read the replay back unquantized.
    det32 = _detector(models, quantized_readback=False)
    prog = det32._program(H, W, mode, face_slab=2)
    with torch.inference_mode(), graphs.capture_now():
        prog(torch.from_numpy(frames))             # captured
        out = prog(torch.from_numpy(frames))       # replayed
    got = {**readback.fetch(out), **{k: v.numpy() for k, v in out.items()
                                     if k.startswith("det_")}}
    assert stand_in.replays == 7
    if mode == FULL:
        _assert_full_match(got, _jax_full(jmodels, frames, face_slab=2,
                                          min_score=0.5))
    else:
        _assert_slabs_match(got, _jax_slab(jmodels, frames, face_slab=2,
                                           min_score=0.5))


def test_replays_keep_distinct_results(setup, stand_in):
    """Each replay's result is cloned out of the graph's outputs: a result
    held across the next replay keeps its values, although the graph's
    own output tensors then hold the next call's."""
    frames, other, models, _ = setup
    prog = _detector(models)._program(H, W, FULL, face_slab=2)
    x1, x2 = torch.from_numpy(frames), torch.from_numpy(other)
    with torch.inference_mode():
        want1, want2 = prog.fn(x1), prog.fn(x2)
        with graphs.capture_now():
            prog(x1)                               # eager, then captured
        r2 = prog(x2)
        r3 = prog(x1)
    assert stand_in.replays == 2
    assert not torch.equal(want1["packed"], want2["packed"])
    tensors = [k for k in want1 if k != "layout"]
    assert tensors == ["packed", "det_boxes", "det_raw_keypoints",
                       "det_scores", "det_valid"]
    for k in tensors:
        assert torch.equal(r2[k], want2[k]) and torch.equal(r3[k], want1[k])
    # What the clone protects against: the graph's outputs alias.
    (_, _, out, _), = prog._graphs.values()
    assert all(torch.equal(out[k], want1[k]) for k in tensors)


def test_depth_two_stream_keeps_results_in_flight(setup, stand_in):
    """A depth-2 stream replays batch N+1's program before batch N's
    overflow re-run reads its ``det_*`` slab; the faces equal the eager
    detector's sequential calls bit for bit."""
    frames, other, models, _ = setup
    batches = [frames, other, frames, other, frames]
    det = _one_face_bucket(_detector(models))
    ref = _one_face_bucket(_detector(models))
    with graphs.capture_now():  # both programs captured on the first batch
        got = list(det.detect_faces_batch_stream(batches, FULL, depth=2))
    with graphs.eager():
        want = [ref.detect_faces_batch(b, FULL) for b in batches]
    assert stand_in.replays == 8
    for g, w in zip(got, want):
        assert _payload(g) == _payload(w)


def _counting_wrapper():
    return types.SimpleNamespace(launches=0, launches_by_size={})


def test_replay_adds_the_captured_tally(stand_in):
    """A program's kernel launches are counted once a call: on the eager
    calls by the wrappers, on each replay (the capturing call's included)
    from the capture's tally; the capture itself counts nothing.  The
    guard runs on every call."""
    k1, k2 = _counting_wrapper(), _counting_wrapper()
    guards = []

    def fn(x):
        _build.count_launch(k1)
        _build.count_launch(k2, 64)
        _build.count_launch(k2, 192)
        return {"y": x * 2}

    prog = graphs.program(fn, CPU, guard=lambda: guards.append(1))
    assert isinstance(prog, graphs.CapturedProgram)
    x = torch.arange(4.0)
    for calls in range(1, graphs.CAPTURE_AT_CALL + 3):
        assert torch.equal(prog(x + calls)["y"], (x + calls) * 2)
        assert k1.launches == calls and len(guards) == calls
        assert k2.launches_by_size == {64: calls, 192: calls}
    assert stand_in.captures == 1 and stand_in.replays == 3
    (_, _, _, tally), = prog._graphs.values()
    assert tally == [(k1, None), (k2, 64), (k2, 192)]


def test_a_failed_guard_stops_the_call(stand_in):
    def refuse():
        raise RuntimeError("allow_tf32")

    prog = graphs.program(lambda x: {"y": x + 1}, CPU, guard=refuse)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        prog(torch.zeros(2))
    assert stand_in.captures == 0


def test_calls_inside_trace_run_eager(setup, stand_in, tmp_path):
    """Inside ``timings.trace`` a captured program runs eagerly: no replay,
    and the trace holds the ``fdt.*`` stage ranges of every FULL stage."""
    frames, _, models, _ = setup
    det = _detector(models)
    # The 1-face slab and its re-run, then the steady key until it replays.
    for _ in range(graphs.CAPTURE_AT_CALL + 2):
        want = det.detect_faces_batch(frames)
    replays = stand_in.replays
    assert replays >= 1 and not timings.tracing()
    with timings.trace(str(tmp_path)):
        assert timings.tracing()
        got = det.detect_faces_batch(frames)
    assert not timings.tracing() and stand_in.replays == replays
    assert _payload(got) == _payload(want)
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    for stage in ("letterbox", "detector", "postprocess", "mesh", "iris",
                  "blendshapes", "refine", "upload", "pack"):
        assert f"fdt.{stage}" in names, stage


def test_keys_differ_by_padded_batch_and_nb(setup, stand_in):
    """The main program keeps one graph a padded batch (3 frames pad to
    the ladder's 4 and share its graph); the face-stage program one a
    re-run width ``nb``.  Under ``capture_now`` each key is captured on
    its first call; outside it a key called once stays pending."""
    frames, _, models, _ = setup
    det = _detector(models, adaptive=False)
    with graphs.capture_now():
        for rows in ([0], [0, 1], [0, 1, 0], [1, 0, 1, 0], [0]):
            det.detect_faces_batch(frames[rows], FULL)
    prog = det._program(H, W, FULL)
    assert sorted(k[0][0][0] for k in prog.keys()) == [1, 2, 4]
    stage = det._face_stage_program(H, W, FULL)
    imgs = torch.from_numpy(frames)
    with torch.inference_mode(), graphs.capture_now():
        slab = readback.fetch(prog(imgs))
        for nb in (2, 4, 2):
            stage(imgs, *(torch.from_numpy(slab[k][:, :nb]) for k in (
                "boxes", "raw_keypoints", "scores", "valid")))
    assert sorted(k[1][0][1] for k in stage.keys()) == [2, 4]
    assert det.memory_report()["compiled_programs"] == 5
    assert stand_in.replays == 4
    det.detect_faces_batch(frames[[0, 1] * 4], FULL)   # a batch of 8, once
    assert sorted(k[0][0][0] for k in prog.keys()) == [1, 2, 4]
    assert [k[0][0][0] for k in prog.pending()] == [8]
    report = det.memory_report()
    assert report["compiled_programs"] == report["captured_keys"] == 5
    assert report["pending_keys"] == 1 and stand_in.captures == 5


def test_dispose_releases_every_graph(setup, stand_in):
    frames, _, models, _ = setup
    det = _detector(models)
    for mode in (STANDARD, FULL):
        with graphs.capture_now():
            for _ in range(2):
                det.detect_faces_batch(frames, mode)
        det.detect_faces_batch(frames[:1], mode)   # a key left pending
    progs = [p for _, p in det._programs.items()]
    assert progs == det._programs.captured()
    report = det.memory_report()
    assert report["compiled_programs"] == sum(len(p.keys()) for p in progs) \
        >= 2
    assert report["pending_keys"] == sum(len(p.pending()) for p in progs) \
        == 2
    assert report["graph_pool_bytes"] == 0   # no card
    det.dispose()
    assert not det._programs.captured() and not det._programs.keys()
    assert all(not p.keys() and not p.capture_s and not p.capture_parts
               and not p.pending() for p in progs)


def test_data_parallel_shards_replay(setup, stand_in, monkeypatch):
    """Under ``data_parallel`` each shard's device runs a captured program
    in that device's pool: two shards of the CPU share one program, and
    the sharded replays give the unsharded eager detector's faces."""
    frames, other, models, _ = setup
    monkeypatch.setattr(sharding, "visible_devices",
                        lambda kind="cuda": [CPU, CPU])
    det = _detector(models, data_parallel=True, adaptive=False)
    ref = _detector(models, adaptive=False)
    assert det._mesh == (CPU, CPU)
    for i, batch in enumerate((frames, other, frames)):
        with graphs.capture_now() if i == 0 else contextlib.nullcontext():
            got = det.detect_faces_batch(batch, FULL)
        with graphs.eager():
            want = ref.detect_faces_batch(batch, FULL)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                bb, wb = a.bounding_box, b.bounding_box
                assert np.abs(np.subtract(
                    [bb.xmin, bb.ymin, bb.xmax, bb.ymax],
                    [wb.xmin, wb.ymin, wb.xmax, wb.ymax])).max() <= 1e-5
                assert np.abs(a.mesh.points - b.mesh.points).max() <= 1e-2
    (prog,) = det._programs.captured()
    assert prog.pool is graphs.pool_for(CPU)
    # The first shard's first call runs eager and captures (capture_now);
    # every other shard call of the three batches replays.
    assert stand_in.captures == 1 and stand_in.replays == 5


def test_standalone_face_detection_keeps_a_program_per_size(setup, stand_in):
    """``FaceDetection`` captures one program per image size and replays
    it: its detections equal the eager program's bit for bit."""
    frames, other, models, _ = setup
    fd = FaceDetection(FaceDetectionModel.BACK_CAMERA, model=models.detector,
                       device="cpu")
    ref = FaceDetection(FaceDetectionModel.BACK_CAMERA, model=models.detector,
                        device="cpu")
    small = np.ascontiguousarray(frames[0, :80, :128])
    found = 0
    for img in (frames[0], other[0], small, frames[1], small):
        with graphs.capture_now():                 # each size's first call
            got = fd(img)
        with graphs.eager():
            want = ref(img)
        assert len(got) == len(want)
        found += len(got)
        for a, b in zip(got, want):
            assert a.bounding_box == b.bounding_box and a.score == b.score
            np.testing.assert_array_equal(a.keypoints_xy, b.keypoints_xy)
    assert found >= 3
    assert sorted(fd._programs.keys()) == [(80, 128), (H, W)]
    assert stand_in.captures == 2 and stand_in.replays == 3
    progs = fd._programs.captured()
    assert len(progs) == 2
    fd.dispose()
    assert not fd._programs.keys() and all(not p.keys() for p in progs)
    with pytest.raises(RuntimeError, match="disposed"):
        fd(frames[0])


def test_a_pool_renews_its_handle_once_its_graphs_are_freed(monkeypatch):
    """PyTorch frees a graph memory pool with its last graph and cannot
    capture into it again, so a pool hands out a new handle where none of
    the graphs it counted live is left, after handing the last pool's
    memory back to the card."""
    class _Held:
        pass

    made = iter(range(100))
    emptied = []
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: (0, next(made)))
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: emptied.append(1))
    pool = graphs.GraphPool(torch.device("cuda", 0))
    a, b = _Held(), _Held()
    assert pool.adopt(a) == pool.adopt(b) == (0, 0)
    del a
    c = _Held()
    assert pool.adopt(c) == (0, 0)     # b still lives in the pool
    assert not emptied
    assert pool.renewals == 0
    del b, c
    assert pool.adopt(_Held()) == (0, 1) and emptied == [1]
    assert pool.renewals == 1


def test_programs_run_eager_without_a_maker(setup):
    """Off a card, with the real seam, the programs are the eager
    functions themselves: nothing is captured."""
    _, _, models, _ = setup
    assert graphs.graph_maker(CPU) is None
    prog = _detector(models)._program(H, W, FULL)
    assert not isinstance(prog, graphs.CapturedProgram)
