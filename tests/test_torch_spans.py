"""The port's host spans, its captured programs' counts and its stage
stamps (``pipeline/timings.py``, ``pipeline/graphs.py``), on the CPU, and
the benchmark's readers of them (``h100_bench/metrics/``).

A span records its host ms into its owner's ``DetectTimings`` with or
without a profiler, and under a ``torch.profiler`` session is also an
``fdt.*`` range carrying its unit, nested in its parent.  A detector's
call records ``compute_wait`` and ``readback`` apart by default.  As in
``tests/test_torch_graphs.py`` the seam ``graphs.graph_maker`` is replaced
by the stand-in whose replays re-run the program; the stamp seam
``timings.stamper`` by one that writes a counter's next value, so that the
stamps' packing, unpacking and ``device.<group>`` accounting run on the
CPU.  The stamps of a real replay are held on the card in
``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from face_detection_tflite_torch import FaceDetectionMode, FaceDetector
from face_detection_tflite_torch.pipeline import graphs, readback, timings
from h100_bench.harness import manifest
from h100_bench.harness.runner import Context
from h100_bench.harness.trace import Trace

from .test_torch_graphs import StandIn
from .torch_parity import MAX_FACES, small_pipeline

N = graphs.CAPTURE_AT_CALL
FULL = FaceDetectionMode.FULL
#: The stage groups a FULL program stamps, and its final stamp.
FULL_STAMPS = ("detect", "mesh", "iris", "blendshapes", "pack")


@pytest.fixture(scope="module")
def setup():
    return small_pipeline()


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


def _detector(models, **kw):
    return FaceDetector(models=models, device="cpu", max_faces=MAX_FACES,
                        allow_untrained_embeddings=True, **kw)


# -- spans -------------------------------------------------------------------

def test_span_records_into_its_owner_without_a_profiler():
    """Without a profiler a span adds its host ms and a count to its
    owner; a span with no owner takes the innermost open span's owner
    and unit, a span with no name only passes them on, and a span with no
    owner anywhere records nothing."""
    t = timings.DetectTimings()
    with timings.span("top", t, 7) as top:
        with timings.span("inner") as inner:
            pass
        with timings.span(None, t, 9):
            with timings.span("other") as other:
                pass
    with timings.span("alone") as alone:
        pass
    assert (top.unit, inner.owner, inner.unit) == (7, t, 7)
    assert other.unit == 9 and alone.owner is None
    assert dict(t.calls) == {"top": 1, "inner": 1, "other": 1}
    assert t.total_ms["top"] >= t.total_ms["inner"] >= 0.0
    with t.stage("stage"):  # the old entry point is a span of its owner
        pass
    assert t.calls["stage"] == 1
    assert not timings._local.spans


def test_span_is_a_range_with_its_unit_and_parent_under_a_profiler():
    """Under a ``torch.profiler`` session a span is the range
    ``fdt.<name>``: its unit is its one recorded input (with
    ``record_shapes``), its parent the enclosing span's range; the host
    ms still reach the owner.  A span with no unit is a plain range."""
    t = timings.DetectTimings()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with timings.span("outer", t, 3):
            with timings.span("inner"):
                torch.ones(3).mul(2)
        with timings.span("bare", t):
            pass
    events = {e.name: e for e in prof.events()}
    inner, outer = events["fdt.inner"], events["fdt.outer"]
    assert inner.cpu_parent is not None
    assert inner.cpu_parent.name == "fdt.outer"
    assert list(inner.concrete_inputs) == [3]
    assert list(outer.concrete_inputs) == [3]
    assert "fdt.bare" in events
    assert dict(t.calls) == {"outer": 1, "inner": 1, "bare": 1}


def test_detector_records_wait_and_readback_apart_by_default(setup):
    """A batch and a single call each record the upload, the dispatch and
    the faces' build once, and the readback's start, its wait and its
    unpack once a program call (an overflow re-run's too); the merged
    ``compute_readback`` stage is gone, and ``detailed_timings`` changes
    nothing.  On the CPU nothing stamps."""
    frames, models, _ = setup
    for detailed in (False, True):
        det = _detector(models, detailed_timings=detailed)
        det.detect_faces_batch(frames)
        det.detect_faces(frames[0])
        calls = dict(det.timings.calls)
        assert calls["upload"] == calls["materialize"] == 2, calls
        reruns = calls.get("face_readback", 0)
        for name in ("pack", "compute_wait", "readback"):
            assert calls[name] == 2 + reruns, (name, calls)
        assert sum(n for k, n in calls.items()
                   if k.startswith("dispatch[")) == 2
        assert not any(k.startswith(("compute_readback", "device."))
                       for k in calls), calls
        assert "track" not in calls   # tracking is off


def test_tracking_is_a_span(setup):
    frames, models, _ = setup
    det = _detector(models, enable_tracking=True)
    det.detect_faces(frames[0])
    assert det.timings.calls["track"] == 1


# -- counts --------------------------------------------------------------------

def _program(maker):
    """A captured program on the CPU through ``maker``."""
    return graphs.CapturedProgram(lambda x: {"y": x * 2 + 1},
                                  graphs.pool_for("cpu"), maker)


def _counts(prog, x):
    return prog.counts()[((tuple(x.shape), x.dtype),)]


def test_counts_follow_the_capture_schedule():
    """N - 1 eager calls, a capture whose first replay is its call's
    result, then replays; each recorded as a span of the enclosing owner
    (``eager``, ``capture``, ``replay``)."""
    maker = StandIn()
    prog = _program(maker)
    x = torch.arange(4.0)
    t = timings.DetectTimings()
    want = {"eager": 0, "replays": 0, "captures": 0}
    for call in range(1, N + 3):
        with timings.span(None, t, call):
            torch.testing.assert_close(prog(x)["y"], x * 2 + 1)
        if call < N:
            want["eager"] += 1
        else:
            want["replays"] += 1
            want["captures"] = 1
        assert _counts(prog, x) == want, call
    assert (maker.captures, maker.replays) == (1, 3)
    assert dict(t.calls) == {"eager": N - 1, "capture": 1, "replay": 3}


def test_counts_under_capture_now_eager_and_release():
    """``capture_now``: one eager call, the capture, no replay, then
    replays.  ``eager()``: an eager call that does not count toward a
    capture.  ``release``: every count forgotten, and the schedule
    starts anew."""
    prog = _program(StandIn())
    x = torch.ones(3)
    with graphs.capture_now():
        prog(x)
    assert _counts(prog, x) == {"eager": 1, "replays": 0, "captures": 1}
    prog(x)
    assert _counts(prog, x) == {"eager": 1, "replays": 1, "captures": 1}
    y = torch.ones(5)
    with graphs.eager():
        prog(y)
    assert _counts(prog, y) == {"eager": 1, "replays": 0, "captures": 0}
    assert ((tuple(y.shape), y.dtype),) not in prog.pending()
    prog.release()
    assert prog.counts() == {}
    for _ in range(N):
        prog(x)
    assert _counts(prog, x) == {"eager": N - 1, "replays": 1,
                                "captures": 1}


def test_memory_report_sums_the_counts(setup, stand_in):
    """``memory_report()``'s ``eager_calls`` and ``replays`` are the sums
    over the detector's captured programs; the warm-up's own calls are
    eager calls too, and a warm detector replays."""
    frames, models, _ = setup
    det = _detector(models)
    det.warmup(frames.shape[1:], batch_size=len(frames), modes=(FULL,))
    warm = det.memory_report()
    assert warm["pending_keys"] == 0 and warm["replays"] == 0
    assert warm["eager_calls"] >= warm["captured_keys"] > 0
    det.detect_faces_batch(frames)
    det.detect_faces_batch(frames)
    after = det.memory_report()
    assert after["replays"] > warm["replays"]
    want = sum(c["eager"] for p in det._programs.captured()
               for c in p.counts().values())
    assert after["eager_calls"] == want
    det.dispose()


def test_memory_report_counts_are_zero_off_a_card(setup):
    frames, models, _ = setup
    det = _detector(models)
    det.detect_faces_batch(frames)
    report = det.memory_report()
    assert (report["eager_calls"], report["replays"]) == (0, 0)


# -- stamps --------------------------------------------------------------------

def test_pack_and_unpack_carry_the_stamps(setup, counter_stamps):
    """The FULL program stamps its groups and its end; the stamps travel
    in every row of the packed readback, the layout names them, and
    ``readback.fetch_finish`` takes them out of the arrays."""
    frames, models, _ = setup
    det = _detector(models)
    h, w = frames.shape[1:3]
    out = det._program(h, w, FULL)(torch.from_numpy(frames))
    layout = out["layout"]
    assert layout.stamps == FULL_STAMPS
    arrays = layout.unpack(out["packed"].numpy())
    rows = arrays[readback.STAMPS]
    assert rows.shape == (len(frames), 2 * len(FULL_STAMPS))
    assert (rows == rows[0]).all()
    stamps = rows[0].view(np.int64)
    assert (np.diff(stamps) == 1).all()
    t = timings.DetectTimings()
    with timings.span(None, t, 1):
        fetched = readback.fetch(out)
    assert readback.STAMPS not in fetched
    assert dict(t.calls) == {"compute_wait": 1, "readback": 1, "pack": 1,
                             **{f"device.{g}": 1 for g in FULL_STAMPS[:-1]}}
    assert t.total_ms["device.iris"] == pytest.approx(1e-6)


def test_stamps_of_a_depth_two_stream_stay_apart(setup, stand_in,
                                                 counter_stamps,
                                                 monkeypatch):
    """Replayed batches at depth 2 with embeddings: each batch's readback
    holds its own program's stamps (a run of consecutive values, later
    than the batch dispatched before it), though the next batch's replay
    stamps the graph's buffer again before the first is read; each
    group's device ms is added once a program call."""
    frames, models, _ = setup
    det = _detector(models, embed_in_full=True)
    seen = []
    real = timings.record_stamps

    def spy(names, values):
        seen.append((tuple(names), [int(v) for v in values]))
        real(names, values)
    monkeypatch.setattr(timings, "record_stamps", spy)
    batches = [frames, frames[::-1].copy()] * (N + 1)
    results = list(det.detect_faces_batch_stream(batches, depth=2))
    assert len(results) == len(batches)
    programs = len(seen)
    assert programs >= len(batches)
    firsts = []
    for names, values in seen:
        assert names[-1] == "pack" and "embedding" in names
        assert np.all(np.diff(values) == 1), values
        if names[0] == "detect":   # a batch's main program, in order
            firsts.append(values[0])
    assert len(firsts) == len(batches)
    assert firsts == sorted(set(firsts))
    assert stand_in.replays > 0
    calls = det.timings.calls
    assert calls["device.embedding"] == programs
    assert calls["device.mesh"] == programs


def test_no_stamps_off_a_card(setup):
    """Without a stamper (the CPU) the program packs no stamps."""
    frames, models, _ = setup
    det = _detector(models)
    h, w = frames.shape[1:3]
    out = det._program(h, w, FULL)(torch.from_numpy(frames))
    assert out["layout"].stamps == ()
    assert readback.STAMPS not in out["layout"].unpack(
        out["packed"].numpy())


def test_stage_range_stamps_only_under_stamping(counter_stamps):
    """A stamped stage range stamps inside ``stamping`` only, in the
    order entered, and not again past the buffer's slots."""
    with timings.stage_range("fdt.mesh"):
        pass
    with timings.stamping(torch.device("cpu")) as st:
        for name in ("fdt.letterbox", "fdt.detector", "fdt.mesh"):
            with timings.stage_range(name):
                pass
        assert st.names == ["detect", "mesh"]
        for _ in range(2 * timings.STAMP_SLOTS):
            st.stamp("pack")
        assert len(st.names) == timings.STAMP_SLOTS
    assert timings._local.stamps is None


# -- the benchmark's readers ---------------------------------------------------

def _ctx(**kw):
    base = {"mix": {"trace_units": 4, "batch": 16},
            "timings": {}, "memory_before": {}, "memory_after": {}}
    base.update(kw)
    return Context(**base)


@pytest.mark.parametrize("metric,key,per", [
    ("upload_ms", "upload", "unit"),
    ("readback_wait_ms", "compute_wait", "unit"),
    ("materialize_ms", "materialize", "unit"),
    ("iris_ms_per_frame", "device.iris", "frame"),
    ("mesh_ms_per_frame", "device.mesh", "frame"),
    ("embedding_ms_per_frame", "device.embedding", "frame"),
    ("upload_ms.single", "upload", "unit"),
    ("iris_ms_per_frame.single", "device.iris", "frame")])
def test_span_readers(metric, key, per):
    """Each span reader divides its span's total ms over the untraced run
    by its units (or frames), and reads nothing where the span is absent
    (a program without it)."""
    read = manifest.reader(metric)
    ctx = _ctx(timings={key: (32.0, 7), "dispatch[slab2]": (1.0, 4)})
    assert read(ctx) == pytest.approx(32.0 / (4 if per == "unit" else 64))
    single = _ctx(timings={key: (32.0, 7)}, mix={"trace_units": 4})
    assert read(single) == pytest.approx(8.0)
    assert read(_ctx(timings={"dispatch[slab2]": (1.0, 4)})) is None


def test_window_eager_calls_reader():
    read = manifest.reader("window_eager_calls")
    assert read(_ctx(memory_before={"eager_calls": 40},
                     memory_after={"eager_calls": 43})) == 3
    assert read(_ctx(memory_before={"eager_calls": 40},
                     memory_after={"eager_calls": 40})) == 0
    assert read(_ctx(memory_before={"captured_keys": 2},
                     memory_after={"captured_keys": 2})) is None


def test_idle_unspanned_share_reader():
    """The device is busy 0-10 and 30-40 us of a 0-60 us window, idle
    10-30 and 40-60 (40 us); the host is inside ``fdt.*`` spans 5-25 us
    (an aten op inside is no span of its own), and in another operator
    only 45-50: 25 us of idle lie in no span, 62.5%."""
    read = manifest.reader("idle_unspanned_share.single")
    device = [(0.0, 10e-6, "k"), (30e-6, 40e-6, "k")]
    host = [(5e-6, 20e-6, "fdt.upload"), (15e-6, 25e-6, "fdt.replay"),
            (16e-6, 17e-6, "aten::copy_"), (45e-6, 50e-6, "cudaMemcpy")]
    ctx = _ctx(trace=Trace(device, host, 0.0, 60.0))
    assert read(ctx) == pytest.approx(62.5)
    ctx = _ctx(trace=Trace(device, host[2:], 0.0, 60.0))
    assert read(ctx) is None
