"""When a captured program captures a key (``pipeline/graphs.py``), on the
CPU.

A key's calls 1 to ``graphs.CAPTURE_AT_CALL - 1`` run the eager program;
call ``CAPTURE_AT_CALL`` captures and takes its result from the graph's
first replay; later calls replay.  Inside ``graphs.capture_now()`` (and so
in ``FaceDetector.warmup``) a key is captured on its first call; inside
``graphs.eager()`` and ``timings.trace`` a call neither captures nor
counts.  As in ``tests/test_torch_graphs.py`` the one seam,
``graphs.graph_maker``, is replaced by the stand-in whose replays re-run
the program into the same static outputs, on the small seeded pipeline of
``tests/torch_parity.py``.  Every case runs for each owner of captured
programs: a ``FaceDetector`` program key, ``FaceDetection``,
``SelfieSegmentation``, ``FaceEmbedding.embed_batch``, ``FaceLandmark``,
``IrisLandmark`` and ``FaceBlendshapesModel``.  Results are held bit for
bit against the eager program (run inside ``graphs.eager``) and the
capturing call's within the existing budgets against the JAX package
(``docs/PARITY.md``).  The real graphs' schedule is checked on the card by
phase 14 of ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
import types
from typing import Callable

import numpy as np
import pytest
import torch

from face_detection_tflite_torch import (FaceBlendshapesModel, FaceDetection,
                                         FaceDetectionMode, FaceDetector,
                                         FaceLandmark, IrisLandmark)
from face_detection_tflite_torch.kernels import build as _build
from face_detection_tflite_torch.models import embedding as te
from face_detection_tflite_torch.models import segmentation as t_seg
from face_detection_tflite_torch.models import standalone as t_standalone
from face_detection_tflite_torch.ops import warp
from face_detection_tflite_torch.pipeline import (graphs, programs,
                                                  readback, timings)
from face_detection_tflite_tpu.models import embedding as je
from face_detection_tflite_tpu.models import segmentation as j_seg
from face_detection_tflite_tpu.models import standalone as j_standalone
from face_detection_tflite_tpu.pipeline.config import (
    MODEL_FILES, FaceDetectionModel as JVariant)

from .test_torch_embedding import _FRAME, _PAIRS
from .test_torch_full import _assert_full_match, _jax_full
from .test_torch_graphs import StandIn
from .test_torch_segmentation import _assert_masks_match, _setup
from .test_torch_standalone import _assert_same_detections
from .torch_parity import H, MAX_FACES, W, rel_err

N = graphs.CAPTURE_AT_CALL
FULL = FaceDetectionMode.FULL
OWNERS = ("FaceDetector", "FaceDetection", "SelfieSegmentation",
          "embed_batch", "FaceLandmark", "IrisLandmark",
          "FaceBlendshapesModel")
#: The owners whose programs launch a hand kernel, and the kernels each
#: call launches once (K2 once at each of its crop sizes).
KERNELS = {"FaceDetector": ("K1", "K2"), "FaceDetection": ("K1",),
           "embed_batch": ("K2",)}
SLAB = ("det_boxes", "det_raw_keypoints", "det_scores", "det_valid")


@pytest.fixture
def stand_in(monkeypatch):
    maker = StandIn()
    monkeypatch.setattr(graphs, "graph_maker", lambda device: maker)
    return maker


@pytest.fixture(scope="module")
def setup():
    return _setup("general")


@pytest.fixture
def jax_classes(setup, monkeypatch):
    """The JAX standalone module, loading the seeded JAX networks by file
    name (as ``tests/test_torch_standalone.py`` does)."""
    _, _, jmodels, _ = setup
    by_file = {MODEL_FILES["back"]: jmodels.detector,
               MODEL_FILES["face_landmark"]: jmodels.mesh,
               MODEL_FILES["iris_landmark"]: jmodels.iris,
               MODEL_FILES["face_blendshapes"]: jmodels.blendshapes}
    monkeypatch.setattr(j_standalone, "_resolve", lambda name, _dir: name)
    monkeypatch.setattr(j_standalone, "convert_file",
                        lambda name, precision: by_file[name])
    return j_standalone


@dataclasses.dataclass
class Case:
    """One owner of captured programs, called on its two inputs (of one
    input signature, so of one program key)."""
    owner: object
    call: Callable[[int], object]
    arrays: Callable[[object], list]
    jax: Callable[[int, object, object], None]

    def programs(self) -> list:
        """The owner's captured programs (its ``graphs.ProgramSet``)."""
        return self.owner._programs.captured()


def _detector(setup) -> Case:
    """The FULL speculative 2-face program key of a ``FaceDetector`` at
    B = 2, its readback unquantized as the JAX program's outputs are."""
    frames, models, jmodels, _ = setup
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                       quantized_readback=False)
    inputs = [frames, np.ascontiguousarray(frames[::-1, ::-1])]

    def call(i):
        with torch.inference_mode():
            out = det._program(H, W, FULL, face_slab=2)(
                torch.from_numpy(inputs[i]))
        return {**readback.fetch(out), **{k: out[k].numpy() for k in SLAB}}

    def jax(i, got, _):
        _assert_full_match(got, _jax_full(jmodels, inputs[i], face_slab=2,
                                          min_score=0.5))
    return Case(det, call, lambda r: [r[k] for k in sorted(r)], jax)


def _face_detection(setup) -> Case:
    frames, models, _, _ = setup
    fd = FaceDetection(model=models.detector, device="cpu",
                       max_detections=8)
    inputs = [frames[0], np.ascontiguousarray(frames[1, ::-1])]

    def jax(i, got, classes):
        _assert_same_detections(got, classes.FaceDetection(
            JVariant.BACK_CAMERA, max_detections=8)(inputs[i]))
    return Case(fd, lambda i: fd(inputs[i]),
                lambda r: [np.asarray(
                    [d.bounding_box.xmin, d.bounding_box.ymin,
                     d.bounding_box.xmax, d.bounding_box.ymax, d.score,
                     *d.keypoints_xy.ravel()]) for d in r], jax)


def _segmentation(setup) -> Case:
    frames, models, _, jseg = setup
    seg = t_seg.SelfieSegmentation(models.segmentation, device="cpu")
    inputs = [frames, np.ascontiguousarray(frames[::-1, ::-1])]

    def jax(i, got, _):
        _assert_masks_match(got, j_seg.SelfieSegmentation(jseg)(inputs[i]))
    return Case(seg, lambda i: seg(inputs[i]),
                lambda r: [m.data for m in r], jax)


def _embedding(setup) -> Case:
    emb = te.FaceEmbedding(te.build_mobilefacenet(0), allow_untrained=True,
                           device="cpu")
    inputs = [_PAIRS, [((50.0, 60.0), (80.0, 75.0)),
                       ((150.0, 40.0), (190.0, 44.0))]]

    def jax(i, got, _):
        want = je.FaceEmbedding(je.build_mobilefacenet(0),
                                allow_untrained=True).embed_batch(
                                    _FRAME, inputs[i])
        assert np.abs(got - want).max() <= 1e-5
    return Case(emb, lambda i: emb.embed_batch(_FRAME, inputs[i]),
                lambda r: [r], jax)


def _crop_network(setup, name: str) -> Case:
    """One of the three single-network classes on two seeded inputs: crops
    for the mesh and iris nets, 146 points for the blendshape net."""
    _, models, _, _ = setup
    rng = np.random.default_rng(5)
    if name == "FaceLandmark":
        net = FaceLandmark(model=models.mesh, device="cpu")
        inputs = [rng.integers(0, 256, (192, 192, 3), dtype=np.uint8)
                  for _ in range(2)]
        call = net.call_with_score
    elif name == "IrisLandmark":
        net = IrisLandmark(model=models.iris, device="cpu")
        inputs = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                  for _ in range(2)]
        call = net
    else:
        net = FaceBlendshapesModel(model=models.blendshapes, device="cpu")
        inputs = [rng.uniform(0.0, 256.0, (146, 2)).astype(np.float32)
                  for _ in range(2)]
        call = net

    def jax(i, got, classes):
        ref = getattr(classes, name)()
        if name == "FaceLandmark":
            want, score = ref.call_with_score(inputs[i])
            assert rel_err(got[0], want) <= 1e-5
            assert abs(got[1] - score) <= 1e-6
        elif name == "IrisLandmark":
            assert rel_err(got, np.asarray(ref(inputs[i]))) <= 1e-5
        else:
            assert np.abs(got - np.asarray(ref(inputs[i]))).max() <= 1e-5
    return Case(net, lambda i: call(inputs[i]),
                lambda r: [r[0], np.float32(r[1])]
                if isinstance(r, tuple) else [r], jax)


def _case(name: str, setup) -> Case:
    return {"FaceDetector": _detector, "FaceDetection": _face_detection,
            "SelfieSegmentation": _segmentation, "embed_batch": _embedding,
            }.get(name, lambda s: _crop_network(s, name))(setup)


def _assert_equal(case: Case, got, want) -> None:
    a, b = case.arrays(got), case.arrays(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _eager(case: Case, i: int):
    with graphs.eager():
        return case.call(i)


def _state(case: Case) -> tuple[int, int]:
    """(keys captured, keys called but not captured) over the owner's
    programs."""
    progs = case.programs()
    assert all(isinstance(p, graphs.CapturedProgram) for p in progs)
    return (sum(len(p.keys()) for p in progs),
            sum(len(p.pending()) for p in progs))


@pytest.mark.parametrize("owner", OWNERS)
def test_a_key_called_once_holds_no_graph(setup, stand_in, owner):
    """One call runs the eager program: no capture, no graph, the key
    pending."""
    case = _case(owner, setup)
    got = case.call(0)
    assert stand_in.captures == stand_in.replays == 0
    assert _state(case) == (0, 1)
    assert all(not p._graphs and not p.capture_s for p in case.programs())
    _assert_equal(case, got, _eager(case, 0))
    if N > 1:
        assert _state(case) == (0, 1)   # the eager call did not count


@pytest.mark.parametrize("owner", OWNERS)
def test_the_nth_call_captures_once_then_replays(setup, stand_in, owner):
    """Calls 1 to N - 1 are eager; call N captures once and its result (the
    first replay's) equals the eager program's bit for bit; later calls
    replay, each result equal to the eager program's."""
    case = _case(owner, setup)
    for call in range(1, N + 3):
        i = call % 2
        got = case.call(i)
        captured = call >= N
        assert stand_in.captures == int(captured), call
        assert stand_in.replays == max(0, call - N + 1), call
        assert _state(case) == ((1, 0) if captured else (0, 1)), call
        _assert_equal(case, got, _eager(case, i))
    (prog,) = [p for p in case.programs() if p.keys()]
    (key,) = prog.keys()
    parts = prog.capture_parts[key]
    assert set(parts) == {"adopt_s", "renewed", "run_s", "end_s",
                          "pool_bytes", "replay_s"}
    assert prog.capture_s[key] >= parts["run_s"] > 0


@pytest.mark.parametrize("owner", OWNERS)
def test_the_capturing_call_matches_jax(setup, stand_in, jax_classes, owner):
    """The capturing call's result, the graph's first replay, within the
    existing budgets of the JAX package's counterpart on the same input."""
    case = _case(owner, setup)
    for call in range(1, N + 1):
        got = case.call(call % 2)
    assert stand_in.captures == 1 and stand_in.replays == 1
    case.jax(N % 2, got, jax_classes)


@pytest.mark.parametrize("owner", OWNERS)
def test_capture_now_captures_on_the_first_call(setup, stand_in, owner):
    """Inside ``capture_now`` a key's first call runs the eager program
    (its result) and captures; the next call outside replays."""
    case = _case(owner, setup)
    with graphs.capture_now():
        got = case.call(0)
        assert stand_in.captures == 1 and stand_in.replays == 0
        assert _state(case) == (1, 0)
    _assert_equal(case, got, _eager(case, 0))
    _assert_equal(case, case.call(1), _eager(case, 1))
    assert stand_in.captures == 1 and stand_in.replays == 1
    with graphs.capture_now(), graphs.eager():     # eager takes precedence
        case.call(0)
    assert stand_in.captures == 1 and stand_in.replays == 1


@pytest.mark.parametrize("owner", OWNERS)
def test_eager_and_traced_calls_neither_capture_nor_count(
        setup, stand_in, owner, tmp_path):
    """Calls inside ``graphs.eager`` and ``timings.trace`` run eagerly and
    are not counted: after them a key still needs N calls to capture."""
    case = _case(owner, setup)
    for _ in range(N + 1):
        _eager(case, 0)
    with timings.trace(str(tmp_path)):
        for _ in range(N + 1):
            case.call(1)
    assert stand_in.captures == 0 and _state(case) == (0, 0)
    for call in range(1, N + 1):
        case.call(0)
        assert stand_in.captures == int(call == N)


class _SlowStandIn(StandIn):
    """The stand-in, its capture held long enough for a second thread to
    reach the same key meanwhile."""

    def __call__(self, fn, static, pool):
        time.sleep(0.2)
        return super().__call__(fn, static, pool)


def _in_threads(case: Case, before, after) -> dict:
    """Runs ``before(i)`` then, once both threads are there, ``after(i)``
    in two threads ``i`` = 0 and 1 at once; returns each ``after(i)``."""
    got: dict = {}
    errors = []
    barrier = threading.Barrier(2)

    def run(i):
        try:
            before(i)
            barrier.wait(timeout=60)
            got[i] = after(i)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return got


@pytest.mark.parametrize("owner", OWNERS)
def test_two_threads_at_the_nth_call_capture_once(setup, monkeypatch,
                                                  owner):
    """Two threads that have each run a key eagerly and reach its call N
    together capture it once, and both replay; each result equals the
    eager program's on its input."""
    assert N >= 3, "each thread runs one counted call before call N"
    maker = _SlowStandIn()
    monkeypatch.setattr(graphs, "graph_maker", lambda device: maker)
    case = _case(owner, setup)
    for _ in range(N - 3):
        case.call(0)
    want = [_eager(case, 0), _eager(case, 1)]
    got = _in_threads(case, case.call, case.call)
    assert maker.captures == 1 and maker.replays == 2
    assert _state(case) == (1, 0)
    for i in (0, 1):
        _assert_equal(case, got[i], want[i])


@pytest.mark.parametrize("owner", OWNERS)
def test_a_thread_new_to_a_key_runs_it_before_capturing(setup, monkeypatch,
                                                        owner):
    """A capture in a thread that has not run the key runs the eager
    program there first (a thread's own cuBLAS and cuDNN handles must not
    be created under capture), and that run is the call's result: two
    such threads at call N capture once and replay nothing; a thread that
    ran the key replays after."""
    maker = _SlowStandIn()
    monkeypatch.setattr(graphs, "graph_maker", lambda device: maker)
    case = _case(owner, setup)
    for _ in range(N - 1):
        case.call(0)
    want = [_eager(case, 0), _eager(case, 1)]
    got = _in_threads(case, lambda i: None, case.call)
    assert maker.captures == 1 and maker.replays == 0
    assert _state(case) == (1, 0)
    for i in (0, 1):
        _assert_equal(case, got[i], want[i])
    _assert_equal(case, case.call(1), want[1])
    assert maker.captures == 1 and maker.replays == 1


@pytest.mark.parametrize("owner", OWNERS)
def test_release_and_dispose_reset_the_counts(setup, stand_in, owner):
    """``release`` forgets a program's counts with its graphs, so a key
    needs N calls again; ``dispose`` releases every program's."""
    case = _case(owner, setup)
    for _ in range(N):
        case.call(0)
    assert _state(case) == (1, 0)
    for prog in case.programs():
        prog.release()
    assert _state(case) == (0, 0)
    for call in range(1, N + 1):
        case.call(1)
        assert stand_in.captures == 1 + int(call == N)
    for prog in case.programs():
        prog.release()
    case.call(0)                                   # counted again
    progs = case.programs()
    case.owner.dispose()
    assert all(not p.keys() and not p.pending() and not p.capture_parts
               for p in progs)


def _counters(monkeypatch) -> dict:
    """Counting stand-ins for K1 and K2 (the CPU runs their plain
    versions, which count nothing): each counts through
    ``kernels.build.count_launch``, so that a capture's tally sees it."""
    k1 = types.SimpleNamespace(launches=0, launches_by_size={})
    k2 = types.SimpleNamespace(launches=0, launches_by_size={})
    post, warp_normalize = programs.detection_postprocess, warp.warp_normalize

    def k1_call(*a, **kw):
        _build.count_launch(k1)
        return post(*a, **kw)

    def k2_call(frames, *a, out_size, **kw):
        _build.count_launch(k2, out_size)
        return warp_normalize(frames, *a, out_size=out_size, **kw)

    monkeypatch.setattr(programs, "detection_postprocess", k1_call)
    monkeypatch.setattr(t_standalone, "detection_postprocess", k1_call)
    monkeypatch.setattr(warp, "warp_normalize", k2_call)
    return {"K1": k1, "K2": k2}


@pytest.mark.parametrize("owner", sorted(KERNELS))
def test_launch_counts_stay_exact(setup, stand_in, monkeypatch, owner):
    """One launch of each kernel (at each crop size) a call: counted by the
    wrapper on an eager call, from the capture's tally on the capturing
    call's replay and on every later replay; the capture itself counts
    nothing.  The same under ``capture_now`` and ``graphs.eager``."""
    counters = _counters(monkeypatch)
    case = _case(owner, setup)
    sizes = {"FaceDetector": {192: 1, 64: 1}, "embed_batch": {112: 1}}.get(
        owner, {})

    def counts():
        return {k: (counters[k].launches, dict(counters[k].launches_by_size))
                for k in KERNELS[owner]}

    def want(calls):
        return {k: (calls * (len(sizes) if k == "K2" else 1),
                    {s: calls * n for s, n in sizes.items()} if k == "K2"
                    else {}) for k in KERNELS[owner]}

    calls = 0
    for call in range(1, N + 3):
        case.call(call % 2)
        calls += 1
        assert counts() == want(calls), call
    assert stand_in.captures == 1 and stand_in.replays == 3
    _eager(case, 0)
    calls += 1
    assert counts() == want(calls)
    for prog in case.programs():
        prog.release()
    with graphs.capture_now():
        case.call(0)
    calls += 1
    assert counts() == want(calls) and stand_in.captures == 2


def test_warmup_captures_each_key_at_once(setup, stand_in):
    """``FaceDetector.warmup`` captures every program key it runs on that
    call (each mode's main program, the adaptive modes' overflow
    face-stage program): nothing is left pending, nothing replayed; a
    later call of a warmed key replays."""
    frames, models, _, _ = setup
    det = FaceDetector(models=models, device="cpu", max_faces=MAX_FACES)
    det.warmup((H, W, 3), batch_size=2)
    report = det.memory_report()
    keys = sum(len(p.keys()) for p in det._programs.captured())
    assert keys == stand_in.captures == report["captured_keys"] == 5
    assert report["pending_keys"] == 0 and stand_in.replays == 0
    zeros = np.zeros((2, H, W, 3), np.uint8)
    det.detect_faces_batch(zeros, FULL)
    assert stand_in.captures == 5 and stand_in.replays == 1
    det.dispose()
