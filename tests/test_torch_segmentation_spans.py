"""The segmenter's stage stamps, host spans and counters on the CPU, and the
benchmark's readers of them (``h100_bench/metrics/``).

As in ``tests/test_torch_spans.py``: the seam ``graphs.graph_maker`` is
replaced by the stand-in whose replays re-run the program, and the stamp
seam ``timings.stamper`` by one that writes a counter's next value, so
that the segmenter's stamps travel behind its planes in the one readback
and reach ``device.segmentation`` on the CPU.  The pipeline is the small
seeded FULL pipeline with a narrow multiclass segmenter
(``torch_parity.SMALL_SEGMENTER``); the stamps of a real replay are held
on the card in ``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from face_detection_tflite_torch import (FaceDetectionMode, FaceDetector,
                                         SegmentationConfig,
                                         SegmentationModel, ServingPipeline)
from face_detection_tflite_torch.convert.executor import convert_model
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.models.segmentation import \
    SelfieSegmentation
from face_detection_tflite_torch.ops.letterbox import (letterbox_image,
                                                       letterbox_params)
from face_detection_tflite_torch.pipeline import graphs, readback, timings
from h100_bench.harness import manifest
from h100_bench.harness.runner import Context

from .test_torch_graphs import StandIn
from .torch_parity import B, H, MAX_FACES, SEED, SMALL_SEGMENTER, W

FULL = FaceDetectionMode.FULL
#: The spans of one batch of ``ServingPipeline(with_segmentation=True)``.
BATCH_SPANS = {"upload", "segment.dispatch", "compute_wait", "pack",
               "readback", "materialize", "segment.wait",
               "segment.materialize"}


@pytest.fixture(scope="module")
def setup():
    """(frames, port models with the narrow multiclass segmenter)."""
    frames = np.random.default_rng(SEED).integers(0, 256, (B, H, W, 3),
                                                  dtype=np.uint8)
    models, *_ = random_init.random_pipeline_models(
        torch.from_numpy(frames), seed=SEED, detector_blocks=1,
        mesh_blocks=1, per_image=12, iris_blocks=1, mixer_blocks=1,
        segmenter="multiclass", segmenter_spec=SMALL_SEGMENTER)
    return frames, models


@pytest.fixture
def stand_in(monkeypatch):
    maker = StandIn()
    monkeypatch.setattr(graphs, "graph_maker", lambda device: maker)
    return maker


@pytest.fixture
def counter_stamps(monkeypatch):
    """Every stamp writes the next value of one counter (as ns)."""
    values = itertools.count(1000)

    def stamp(buf, slot):
        buf[slot] = next(values)
    monkeypatch.setattr(timings, "stamper", lambda device: stamp)


def _detector(models, mask_dtype="float32"):
    return FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                        segmentation_config=SegmentationConfig(
                            model=SegmentationModel.MULTICLASS,
                            mask_dtype=mask_dtype, precision="highest"))


def _layout(handle):
    """The readback layout of a ``SelfieSegmentation.dispatch`` handle."""
    (_, _, layout), *_ = handle
    return layout


def _planes(masks):
    return [np.stack([m.data for m in masks]),
            np.stack([m.class_data for m in masks])]


# -- stamps --------------------------------------------------------------------

@pytest.mark.parametrize("mask_dtype", ["float32", "uint8"])
def test_the_segmenters_program_stamps_its_group(setup, monkeypatch,
                                                 mask_dtype):
    """Under a stamper the program stamps its start and its end: the
    stamps ride in every row of the readback, the masks equal an
    unstamped run's bit for bit, and after the mask wait the enclosing
    span's owner gets ``device.segmentation`` once, with the three
    ``segment.*`` spans."""
    frames, models = setup
    seg = _detector(models, mask_dtype)._segmentation
    want = _planes(seg(frames))
    handle = seg.dispatch(frames)
    assert _layout(handle).stamps == ()  # no stamper: no stamps
    seg.materialize(handle)
    values = itertools.count(1000)
    monkeypatch.setattr(timings, "stamper", lambda device: (
        lambda buf, slot: buf.__setitem__(slot, next(values))))
    handle = seg.dispatch(frames)
    assert _layout(handle).stamps == ("segmentation", "pack")
    t = timings.DetectTimings()
    with timings.span(None, t, 5):
        got = _planes(seg.materialize(handle))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert dict(t.calls) == {"segment.wait": 1, "segment.materialize": 1,
                             "device.segmentation": 1}
    assert t.total_ms["device.segmentation"] == pytest.approx(1e-6)


def test_each_replay_stamps_its_own_call(setup, stand_in, counter_stamps):
    """A captured program stamps at every replay, and each call's masks
    carry their own stamps: one ``device.segmentation`` a call."""
    frames, models = setup
    det = _detector(models)
    seg = det._segmentation
    with graphs.capture_now():
        want = _planes(seg(frames))
    t = timings.DetectTimings()
    for unit in (1, 2):
        with timings.span(None, t, unit):
            got = _planes(seg.materialize(seg.dispatch(frames)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert stand_in.replays == 2
    assert t.calls["device.segmentation"] == 2
    assert t.calls["segment.dispatch"] == 2


@pytest.mark.parametrize("mask_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("kind", ["general", "multiclass"])
def test_the_segmenters_readback_holds_the_networks_planes(counter_stamps,
                                                          kind, mask_dtype):
    """The segmenter reads its planes back through
    ``pipeline/readback.py``: the masks equal the plain network's planes
    (the person plane, or the six softmax planes; uint8 as ``round(clip(p,
    0, 1) * 255)``), each batch adds ``device.segmentation`` once, and
    uint8 codes come back as codes, not as flags."""
    multiclass = kind == "multiclass"
    net = convert_model(random_init.segmenter_ir(kind, SEED + 5,
                                                 SMALL_SEGMENTER))
    seg = SelfieSegmentation(net, multiclass, mask_dtype=mask_dtype,
                             device="cpu")
    frames = np.random.default_rng(SEED + 1).integers(0, 256, (B, H, W, 3),
                                                      dtype=np.uint8)
    with torch.inference_mode():
        (raw,) = net(letterbox_image(torch.from_numpy(frames),
                                     letterbox_params(H, W, seg.in_h,
                                                      seg.in_w)))
        raw = raw.reshape(B, seg.in_h, seg.in_w, -1)
        planes = torch.softmax(raw, dim=-1) if multiclass else raw[..., :1]
        codes = torch.round(torch.clamp(planes, 0.0, 1.0) * 255.0).to(
            torch.uint8).numpy()
    want = (codes.astype(np.float32) * (1.0 / 255.0)
            if mask_dtype == "uint8" else planes.numpy())
    t = timings.DetectTimings()
    for unit in (1, 2):
        handle = seg.dispatch(frames)
        with timings.span(None, t, unit):
            masks = seg.materialize(handle)
        got = readback.unpack(handle[0])["planes"]   # no span: no stamps
        if mask_dtype == "uint8":
            assert got.dtype == np.uint8 and got.max() > 1
            np.testing.assert_array_equal(got, codes)
        else:
            assert got.dtype == np.float32
        for m, w in zip(masks, want):
            if multiclass:
                np.testing.assert_array_equal(m.class_data, w)
                np.testing.assert_array_equal(m.data, 1.0 - w[..., 0])
            else:
                np.testing.assert_array_equal(m.data, w[..., 0])
    assert t.calls["device.segmentation"] == 2
    assert t.total_ms["device.segmentation"] == pytest.approx(2e-6)


# -- spans ---------------------------------------------------------------------

@pytest.fixture
def span_log(monkeypatch):
    """Every named span that closes: (name, owner, unit, thread name)."""
    log = []
    real = timings.span.__exit__

    def spy(self, *exc):
        if self.name is not None:
            log.append((self.name, self.owner, self.unit,
                        threading.current_thread().name))
        return real(self, *exc)
    monkeypatch.setattr(timings.span, "__exit__", spy)
    return log


def test_pipeline_spans_land_in_the_batchs_unit(setup, counter_stamps,
                                                span_log):
    """``ServingPipeline(with_segmentation=True)``: each batch's spans
    carry its number, the upload on the submitting thread and the
    segmenter's ``segment.*`` spans with the detection's on the worker;
    each batch's masks stamp ``device.segmentation`` once; the answers
    equal the serial combined call's."""
    frames, models = setup
    det = _detector(models)
    batches = [frames, np.ascontiguousarray(frames[::-1]), frames]
    want = [det.detect_faces_with_segmentation_batch(b) for b in batches]
    det.timings.reset()
    del span_log[:]
    with ServingPipeline(det, FULL, depth=2, with_segmentation=True) as pipe:
        got = [f.result(timeout=120) for f in
               [pipe.submit(b) for b in batches]]
    for g, w in zip(got, want):
        for (gf, gm), (wf, wm) in zip(g, w):
            assert len(gf) == len(wf)
            np.testing.assert_array_equal(gm.class_data, wm.class_data)
    # The submitting thread's upload, and the worker's preparation of the
    # batch already on the device, each an ``upload`` span of the unit.
    uploads = [(u, th) for name, _, u, th in span_log if name == "upload"]
    units = sorted({u for u, _ in uploads})
    assert len(units) == len(batches)
    assert {th for _, th in uploads} == {threading.current_thread().name,
                                        "fdt-serving"}
    for unit in units:
        mine = [(n, o, th) for n, o, u, th in span_log if u == unit]
        names = {n for n, _, _ in mine}
        assert BATCH_SPANS <= names, names
        assert any(n.startswith("dispatch[") for n in names)
        assert all(o is det.timings for _, o, _ in mine)
        assert {th for n, _, th in mine if n.startswith("segment.")} == {
            "fdt-serving"}
    calls = det.timings.calls
    for name in ("segment.dispatch", "segment.wait", "segment.materialize",
                 "device.segmentation", "materialize"):
        assert calls[name] == len(batches), (name, dict(calls))
    assert calls["upload"] == 2 * len(batches)


def test_pipeline_spans_are_ranges_with_the_batchs_unit(setup):
    """Under a profiler that records every thread, the worker's
    ``segment.*`` spans are ``fdt.segment.*`` ranges whose one recorded
    input is the batch's number, as the upload's is."""
    frames, models = setup
    det = _detector(models)
    with ServingPipeline(det, FULL, depth=2, with_segmentation=True) as pipe:
        pipe.submit(frames).result(timeout=120)     # the worker is up
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            pipe.submit(frames).result(timeout=120)
    units = {}
    for e in prof.events():
        if e.name in ("fdt.upload", "fdt.segment.dispatch",
                      "fdt.segment.wait", "fdt.segment.materialize"):
            units.setdefault(e.name, set()).update(e.concrete_inputs)
    assert set(units) == {"fdt.upload", "fdt.segment.dispatch",
                          "fdt.segment.wait", "fdt.segment.materialize"}
    assert len(set(map(frozenset, units.values()))) == 1
    assert len(units["fdt.upload"]) == 1


@pytest.mark.parametrize("single", [False, True])
def test_the_combined_calls_upload_once_in_a_span(setup, span_log, single):
    """``detect_faces_with_segmentation_batch`` and
    ``detect_faces_with_segmentation``: one ``upload`` span a call, the
    segmenter's ``segment.*`` spans and the detection's in the same
    unit."""
    frames, models = setup
    det = _detector(models)
    if single:
        det.detect_faces_with_segmentation(frames[0])
    else:
        det.detect_faces_with_segmentation_batch(frames)
    names = [n for n, _, _, _ in span_log]
    assert names.count("upload") == 1
    assert {"segment.dispatch", "segment.wait", "segment.materialize",
            "compute_wait", "materialize"} <= set(names)
    assert len({u for _, _, u, _ in span_log}) == 1
    assert det.timings.calls["upload"] == 1


# -- counters --------------------------------------------------------------------

def test_memory_report_counts_the_segmenters_programs(setup, stand_in):
    """``captured_keys``, ``pending_keys``, ``eager_calls`` and ``replays``
    are summed over the detector's and the segmenter's captured programs;
    ``segmentation_replays`` gives the segmenter's replays apart."""
    frames, models = setup
    det = _detector(models)
    det.detect_faces_with_segmentation_batch(frames)
    (seg,) = det._segmentation._programs.captured()

    def total(key):
        return sum(c[key] for p in det._programs.captured() + [seg]
                   for c in p.counts().values())
    report = det.memory_report()
    progs = det._programs.captured() + [seg]
    assert report["pending_keys"] == sum(len(p.pending()) for p in progs)
    assert len(seg.pending()) == 1 and report["captured_keys"] == 0
    with graphs.capture_now():
        det.detect_faces_with_segmentation_batch(frames)
    det.detect_faces_with_segmentation_batch(frames)
    report = det.memory_report()
    progs = det._programs.captured() + [seg]
    assert report["captured_keys"] == sum(len(p.keys()) for p in progs)
    assert len(seg.keys()) == 1 and not seg.pending()
    assert report["pending_keys"] == sum(len(p.pending()) for p in progs)
    assert report["eager_calls"] == total("eager")
    assert report["replays"] == total("replays")
    # The capture's call replays (this thread ran the key before), and
    # the next call.
    assert report["segmentation_replays"] == 2 == sum(
        c["replays"] for c in seg.counts().values())
    det.dispose()


def test_memory_report_segmentation_replays_off_a_card(setup):
    frames, models = setup
    det = _detector(models)
    det.detect_faces_with_segmentation_batch(frames)
    report = det.memory_report()
    assert (report["segmentation_replays"], report["captured_keys"]) == (0, 0)


def test_a_pipeline_submitted_under_capture_now_captures_on_the_worker(
        setup, stand_in):
    """``capture_now()`` around ``submit`` reaches the worker: every key a
    batch calls, the segmenter's among them, is captured at its first
    call, and ``eager()`` keeps them eager."""
    frames, models = setup
    det = _detector(models)
    with ServingPipeline(det, FULL, depth=2, with_segmentation=True) as pipe:
        with graphs.eager():
            pipe.submit(frames).result(timeout=120)
        assert det.memory_report()["captured_keys"] == 0
        with graphs.capture_now():
            pipe.submit(frames).result(timeout=120)
        report = det.memory_report()
        assert report["pending_keys"] == 0 and report["captured_keys"] > 0
        assert len(det._segmentation._programs.captured()[0].keys()) == 1
        pipe.submit(frames).result(timeout=120)
    assert det.memory_report()["segmentation_replays"] == 1


# -- the benchmark's readers -----------------------------------------------------

def _ctx(timings_):
    return Context(mix={"trace_units": 4, "batch": 16}, timings=timings_,
                   config={"networks": {"segmentation": {
                       "name": "selfie_multiclass"}}})


@pytest.mark.parametrize("metric,key,per", [
    ("segmentation_ms_per_frame", "device.segmentation", "frame"),
    ("mask_wait_ms", "segment.wait", "unit"),
    ("mask_materialize_ms", "segment.materialize", "unit")])
def test_segment_readers(metric, key, per):
    """Each divides its span's or stamp's ms over the untraced run by its
    units (or frames), and reads nothing without it (the parent's
    program)."""
    read = manifest.reader(metric)
    ctx = _ctx({key: (32.0, 4), "dispatch[slab2]": (1.0, 4)})
    assert read(ctx) == pytest.approx(32.0 / (4 if per == "unit" else 64))
    assert read(_ctx({"dispatch[slab2]": (1.0, 4), "materialize": (3.0, 4),
                      "device.iris": (8.0, 4)})) is None


def test_segmentation_mfu_reader():
    """The segmenter's FLOPs (715,129,664 multiply-adds, 2 FLOPs each, a
    frame) over its stamped seconds at 67 TFLOP/s: 64 frames in 32 ms is
    4.27%; nothing without the stamp or the network."""
    read = manifest.reader("segmentation_mfu")
    want = 100.0 * 2 * 715_129_664 * 64 / (32e-3 * 67e12)
    assert read(_ctx({"device.segmentation": (32.0, 4)})) == \
        pytest.approx(want)
    assert read(_ctx({"device.iris": (32.0, 4)})) is None
    none = Context(mix={"trace_units": 4, "batch": 16},
                   timings={"device.segmentation": (32.0, 4)},
                   config={"networks": {"segmentation": None}})
    assert read(none) is None
