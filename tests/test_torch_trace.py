"""The port's trace: ``pipeline.timings.trace``, the ``fdt.*`` stage
ranges, ``tools/trace_capture_torch.py``'s attribution, and two of the
JAX package's names the port lacked.

On the small seeded pipeline on the CPU (``torch_parity.small_pipeline``):
``trace`` writes a Chrome trace holding every range of a FULL call with
embeddings and the host spans around them (``pipeline/timings.py``), each
span with its batch's number; every aten op of the traced calls lies in
exactly one stage range;
the outputs with and without the trace are equal bit for bit, and equal
to the JAX package's within ``test_torch_full``'s tolerances.
The ranges are entered only while a profiler runs, a worker thread's
too.  ``stage_breakdown`` is held on hand-built traces of the form the profiler
writes with CUDA: a kernel launched through ``ctypes`` with no aten op
above it, a kernel that runs after its range has closed, a copy on a
second stream, a worker thread's launch, a kernel that only a
``gpu_user_annotation`` span reaches, and one that nothing reaches.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
from face_detection_tflite_torch.convert import checkpoint as t_ckpt
from face_detection_tflite_torch.models import embedding as te
from face_detection_tflite_torch.pipeline import timings
from face_detection_tflite_torch.pipeline.programs import \
    build_pipeline_program
from face_detection_tflite_torch.utils import native as t_native
from face_detection_tflite_tpu.pipeline import programs as j_programs
from face_detection_tflite_tpu.pipeline.config import \
    FaceDetectionMode as JMode
from face_detection_tflite_tpu.utils import native as j_native

from .test_torch_full import _assert_full_match
from .torch_parity import H, MAX_FACES, W, small_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The ranges a FULL call with embeddings enters.
FULL_EMBED_STAGES = {"fdt.upload", "fdt.letterbox", "fdt.detector",
                     "fdt.postprocess", "fdt.mesh", "fdt.iris",
                     "fdt.blendshapes", "fdt.refine", "fdt.embedding",
                     "fdt.pack"}
#: Every stage range: what holds each op (the upload, the readback's start
#: and its unpack are host spans that hold ops too).
STAGES = FULL_EMBED_STAGES | {"fdt.embed", "fdt.segmentation",
                              "fdt.readback"}
#: The host spans around the stages of a batch on the CPU, by name less
#: its bracket (an overflow re-run's among them).
BATCH_SPANS = {"fdt.dispatch", "fdt.compute_wait", "fdt.readback",
               "fdt.face_stages", "fdt.face_readback", "fdt.materialize"}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_capture_torch",
        os.path.join(REPO, "tools", "trace_capture_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    return small_pipeline()


def _detector(models, **kw):
    return FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                        allow_untrained_embeddings=True, **kw)


def _events(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)["traceEvents"]


def _traced(tmp_path, fn):
    """(result of fn(), the events of the one trace ``trace`` wrote)."""
    with timings.trace(str(tmp_path)):
        result = fn()
    paths = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(paths) == 1, paths
    return result, _events(paths[0])


def _ranges(events):
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("fdt.")]


def _names(events) -> set:
    """The ``fdt.*`` ranges' names, each less its bracket."""
    return {re.sub(r"\[.*\]$", "", r["name"]) for r in _ranges(events)}


def _assert_each_op_in_one_range(events):
    """Every aten op lies inside exactly one stage range (:data:`STAGES`)
    of its thread, so no op is left out and no two stage ranges nest; the
    host spans hold stage ranges."""
    ranges = [r for r in _ranges(events) if r["name"] in STAGES]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert ops and ranges
    for op in ops:
        t0, t1 = float(op["ts"]), float(op["ts"]) + float(op["dur"])
        holders = [r["name"] for r in ranges
                   if (r["pid"], r["tid"]) == (op["pid"], op["tid"])
                   and float(r["ts"]) <= t0
                   and t1 <= float(r["ts"]) + float(r["dur"])]
        assert len(holders) == 1, (op["name"], op["args"], holders)


def _face_arrays(batches):
    """Every array and number of the faces of a list of batch results,
    in order."""
    out = []
    for faces in batches:
        for per in faces:
            for f in per:
                det = f.detection_data
                bb = det.bounding_box
                out += [np.asarray([bb.xmin, bb.ymin, bb.xmax, bb.ymax,
                                    det.score]),
                        np.asarray(det.keypoints_xy), f.mesh.points,
                        f.iris_points, f.blendshapes.scores, f.embedding]
    return out


def test_trace_holds_every_stage_of_a_full_call_with_embeddings(
        setup, tmp_path):
    """Two FULL batches with embeddings (the first overflows the 1-face
    slab, so the re-run's face stages run too) under ``trace``: one
    Chrome trace named as ``tensorboard_trace_handler`` names it, holding
    every stage range, each aten op in exactly one; the faces equal those
    of a second detector running the same batches untraced, bit for
    bit."""
    frames, models, _ = setup
    traced_det = _detector(models, embed_in_full=True)
    faces, events = _traced(tmp_path, lambda: [
        traced_det.detect_faces_batch(frames) for _ in range(2)])
    assert any(k.startswith("face_stages[") for k in traced_det.timings.calls)
    assert _names(events) == FULL_EMBED_STAGES | BATCH_SPANS
    _assert_each_op_in_one_range(events)
    # Each host span carries its batch's number: two batches, two units.
    units = {str(r["args"]["Concrete Inputs"][0]) for r in _ranges(events)
             if r["name"] not in STAGES}
    assert units == {"1", "2"}, units
    plain_det = _detector(models, embed_in_full=True)
    plain = [plain_det.detect_faces_batch(frames) for _ in range(2)]
    got, want = _face_arrays(faces), _face_arrays(plain)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", [FaceDetectionMode.FAST,
                                  FaceDetectionMode.STANDARD])
def test_each_op_in_one_range_in_the_other_modes(setup, tmp_path, mode):
    frames, models, _ = setup
    det = _detector(models)
    _, events = _traced(tmp_path, lambda: [
        det.detect_faces_batch(frames, mode) for _ in range(2)])
    _assert_each_op_in_one_range(events)
    want = {"fdt.upload", "fdt.letterbox", "fdt.detector",
            "fdt.postprocess", "fdt.pack", "fdt.dispatch",
            "fdt.compute_wait", "fdt.readback", "fdt.materialize"}
    if mode is FaceDetectionMode.STANDARD:
        want.add("fdt.mesh")
    assert _names(events) - {"fdt.face_stages", "fdt.face_readback"} == want


def test_single_image_and_standalone_embeddings_are_ranged(setup, tmp_path):
    """``detect_faces`` and ``get_face_embeddings`` on one frame: the
    upload in ``fdt.upload``, the standalone embeddings in ``fdt.embed``,
    every aten op in one range."""
    frames, models, _ = setup
    det = _detector(models)
    (faces, embs), events = _traced(tmp_path, lambda: (
        lambda fs: (fs, det.get_face_embeddings(fs, frames[0])))(
            det.detect_faces(frames[0])))
    assert faces and all(e is not None for e in embs)
    _assert_each_op_in_one_range(events)
    names = _names(events)
    assert {"fdt.upload", "fdt.embed", "fdt.pack"} <= names


@pytest.mark.parametrize("face_slab", [None, 2])
def test_program_outputs_are_unchanged_by_the_trace(setup, tmp_path,
                                                    face_slab):
    """The FULL program with embeddings, direct and speculative: its
    outputs under ``trace`` equal those without bit for bit, and the JAX
    program's within ``test_torch_full``'s tolerances (embeddings within
    1e-4)."""
    frames, models, jmodels = setup
    prog = build_pipeline_program(models, H, W, FaceDetectionMode.FULL,
                                  max_faces=MAX_FACES, face_slab=face_slab,
                                  with_embeddings=True)
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        plain = prog(x)
        traced, _ = _traced(tmp_path, lambda: prog(x))
    assert set(plain) == set(traced)
    for k in plain:
        assert torch.equal(plain[k], traced[k]) or (
            plain[k].is_floating_point() and torch.equal(
                torch.nan_to_num(plain[k], nan=7.0),
                torch.nan_to_num(traced[k], nan=7.0))), k
    fn = jax.jit(j_programs.build_pipeline_program(
        jmodels, H, W, JMode.FULL, max_faces=MAX_FACES, face_slab=face_slab,
        with_embeddings=True))
    ref = {k: np.asarray(v) for k, v in fn(jmodels.params, frames).items()}
    got = {k: v.numpy() for k, v in traced.items()}
    emb, ref_emb = got.pop("embeddings"), ref.pop("embeddings")
    _assert_full_match(got, ref)
    v = got["valid"]
    assert v.any() and np.abs(emb[v] - ref_emb[v]).max() <= 1e-4


def test_trace_writes_the_handler_form_and_cpu_only_here(tmp_path):
    """On a host without CUDA the trace holds CPU activities only, in a
    file ``<host>_<pid>.<ns>.pt.trace.json`` that the JAX tool's glob
    finds."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the trace records the card too")
    _, events = _traced(tmp_path, lambda: torch.ones(3) + 1)
    (path,) = glob.glob(str(tmp_path / "**" / "*.trace.json*"),
                        recursive=True)
    assert re.search(rf"_{os.getpid()}\.\d+\.pt\.trace\.json$",
                     os.path.basename(path)), path
    assert not any(e.get("cat") in timings.DEVICE_CATEGORIES
                   for e in events)
    assert any(e.get("name") == "aten::add" for e in events)


def test_ranges_are_entered_only_while_a_profiler_runs(tmp_path):
    """Outside a profiler ``stage_range`` enters nothing; under ``trace``
    it is a ``record_function`` range, also on a thread started before the
    window opened."""
    import threading

    assert not isinstance(timings.stage_range("fdt.detector"),
                          torch.profiler.record_function)
    opened, done = threading.Event(), threading.Event()

    def worker():
        opened.wait()
        with timings.stage_range("fdt.iris"):
            torch.ones(3).mul(2)
        done.set()

    thread = threading.Thread(target=worker)
    thread.start()

    def window():
        assert isinstance(timings.stage_range("fdt.mesh"),
                          torch.profiler.record_function)
        opened.set()
        done.wait()

    _, events = _traced(tmp_path, window)
    thread.join()
    (r,) = _ranges(events)
    assert r["name"] == "fdt.iris"
    assert r["tid"] == thread.native_id
    assert not isinstance(timings.stage_range("fdt.detector"),
                          torch.profiler.record_function)


# -- stage_breakdown on hand-built CUDA-shaped traces -------------------------

MAIN, WORKER, PID = 11, 12, 100
COMPUTE, UPLOAD_STREAM = 7, 9


def _x(cat, name, ts, dur, pid=PID, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _hand_built():
    """A trace of the profiler's Chrome form with CUDA activities."""
    return [
        {"ph": "M", "name": "process_name", "pid": PID, "tid": 0,
         "args": {"name": "python"}},
        # fdt.upload: the pinned copy on the upload stream.
        _x("user_annotation", "fdt.upload", 0.0, 20.0),
        _x("cuda_runtime", "cudaMemcpyAsync", 5.0, 2.0, correlation=1),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 8.0, 30.0, pid=0,
           tid=UPLOAD_STREAM, correlation=1),
        # fdt.postprocess: K1 through ctypes (no aten op above its launch);
        # the kernel runs while the host is already inside fdt.mesh.
        _x("user_annotation", "fdt.postprocess", 30.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 32.0, 3.0, correlation=2),
        _x("kernel", "detection_postprocess_kernel", 60.0, 12.0, pid=0,
           tid=COMPUTE, correlation=2),
        # fdt.mesh: an aten op's kernel, run after the range has closed.
        _x("user_annotation", "fdt.mesh", 50.0, 30.0),
        _x("cpu_op", "aten::add", 55.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 58.0, 3.0, correlation=3),
        _x("kernel", "vectorized_elementwise_kernel", 90.0, 8.0, pid=0,
           tid=COMPUTE, correlation=3),
        # A worker thread's fdt.iris at the time of the main thread's
        # fdt.postprocess: the launch's thread decides.
        _x("user_annotation", "fdt.iris", 30.0, 10.0, tid=WORKER),
        _x("cuda_runtime", "cudaLaunchKernel", 33.0, 3.0, tid=WORKER,
           correlation=4),
        _x("kernel", "warp_normalize_kernel", 100.0, 5.0, pid=0,
           tid=COMPUTE, correlation=4),
        # No runtime record: only the stream's gpu_user_annotation links.
        _x("gpu_user_annotation", "fdt.embedding", 110.0, 20.0, pid=0,
           tid=COMPUTE),
        _x("kernel", "conv_kernel", 112.0, 6.0, pid=0, tid=COMPUTE,
           correlation=5),
        # Nothing links this one (the trace's own marker, say).
        _x("cuda_runtime", "cudaLaunchKernel", 200.0, 1.0, correlation=6),
        _x("kernel", "spin_kernel", 210.0, 1.0, pid=0, tid=COMPUTE,
           correlation=6),
        # Host-only events are not device time.
        _x("cpu_op", "aten::empty", 1.0, 1.0),
        {"ph": "s", "cat": "ac2g", "id": 2, "pid": PID, "tid": MAIN,
         "ts": 32.0, "name": "ac2g"},
    ]


def test_stage_breakdown_links_launches_and_annotations(tmp_path):
    path = tmp_path / "hand.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": _hand_built()}))
    bd = _tool().stage_breakdown(str(path))
    rows = bd["stages"]
    assert set(rows) == {"fdt.upload", "fdt.postprocess", "fdt.mesh",
                         "fdt.iris", "fdt.embedding", "unattributed"}
    want = {"fdt.upload": (0.030, 0, 1), "fdt.postprocess": (0.012, 1, 0),
            "fdt.mesh": (0.008, 1, 0), "fdt.iris": (0.005, 1, 0),
            "fdt.embedding": (0.006, 1, 0), "unattributed": (0.001, 1, 0)}
    for stage, (ms, kernels, copies) in want.items():
        assert rows[stage]["device_ms"] == pytest.approx(ms), stage
        assert (rows[stage]["kernels"], rows[stage]["copies"]) == \
            (kernels, copies), stage
    assert rows["fdt.postprocess"]["by_name"] == {
        "detection_postprocess_kernel": [pytest.approx(0.012), 1]}
    assert bd["links"] == {"launch": 4, "annotation": 1, "none": 1}
    assert bd["device_ms"] == pytest.approx(0.062)
    # Union of [8, 38], [60, 72], [90, 98], [100, 105], [112, 118],
    # [210, 211] us; the window runs from 8 to 211 us.
    assert bd["busy_ms"] == pytest.approx(0.062)
    assert bd["window_ms"] == pytest.approx(0.203)
    assert bd["attributed_share"] == pytest.approx(0.061 / 0.062)


def test_stage_breakdown_of_the_cpu_trace_has_no_device_rows(setup,
                                                              tmp_path):
    frames, models, _ = setup
    det = _detector(models)
    _traced(tmp_path, lambda: det.detect_faces_batch(frames))
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    bd = _tool().stage_breakdown(path)
    assert bd["stages"] == {"unattributed": {
        "device_ms": 0.0, "kernels": 0, "copies": 0, "by_name": {},
        "top": []}}
    assert bd["device_ms"] == bd["busy_ms"] == bd["attributed_share"] == 0


# -- the JAX names the port lacked -------------------------------------------


def test_face_embedding_load_takes_the_jax_keyword(tmp_path):
    """``FaceEmbedding.load(tflite_path=...)`` as in the JAX package: a
    ``.npz`` checkpoint by keyword, None for the seeded network, a
    missing file raises naming the keyword."""
    net = te.build_mobilefacenet(3)
    path = str(tmp_path / "mfn.npz")
    t_ckpt.save_params_npz(net, path)
    emb = te.FaceEmbedding.load(tflite_path=path, device="cpu")
    assert emb.is_pretrained and emb.model.name == "mobilefacenet-imported"
    for k, v in net.state_dict().items():
        assert torch.equal(emb.model.state_dict()[k], v)
    rand = te.FaceEmbedding.load(tflite_path=None, allow_untrained=True,
                                 device="cpu")
    assert not rand.is_pretrained
    with pytest.raises(FileNotFoundError, match="tflite_path=None"):
        te.FaceEmbedding.load(tflite_path=str(tmp_path / "none.tflite"),
                              device="cpu")


def test_jpeg_decoder_pool_is_the_image_decoder_pool():
    assert t_native.JpegDecoderPool is t_native.ImageDecoderPool
    assert "JpegDecoderPool" in t_native.__all__
    assert j_native.JpegDecoderPool is j_native.ImageDecoderPool
