"""Per-stage timing instrumentation: host spans, the programs' stage
ranges, and stage stamps inside captured programs.

Analog of the reference's stopwatch instrumentation: `WebDetectTimings`
(`face_detector_web.dart:33-57`, per-stage µs gated on `debugTimings`) and
the detect/segment stage stopwatches (`face_detector.dart:1303-1316`).

**Host spans.**  :class:`span` times one piece of the host path (the
upload, a program's dispatch, the readback wait, the face objects' build).
Entering one always adds its host ms and a count to its owner's
:class:`DetectTimings` under its bare name (``upload``, ``replay``); while
a profiler runs it is also a ``record_function`` range named
``fdt.<name>``, on the profiler's clock beside the device's records, with
the span's unit (the detector's call or batch number) as its one recorded
input, so that a depth-2 stream's interleaved batches stay apart in a trace
taken with ``record_shapes``.  Spans nest: one opened with no owner (in
``pipeline/upload.py`` or ``pipeline/graphs.py``, where no detector is in
reach) records into the owner of the innermost span open on its thread,
and takes its unit.  A span with no name only sets the owner and unit of
the spans inside it.  ``DetectTimings.stage(name)`` is a span of that
detector.

**Stage ranges.**  Inside a program each stage runs in a
``record_function`` range of a fixed name (``fdt.letterbox``,
``fdt.detector``, ``fdt.postprocess``, ``fdt.mesh``, ``fdt.iris``,
``fdt.blendshapes``, ``fdt.refine``, ``fdt.embedding``, ``fdt.pack``;
``fdt.segmentation`` and ``fdt.embed`` around the segmenter's and
``FaceEmbedding``'s own calls), the counterpart of the op metadata that
ties XLA's fusions to the JAX package's stage functions.  They are entered
through :func:`stage_range`, which enters one only while a profiler runs,
so that a call outside a trace pays a flag read a stage and not
``record_function``'s dispatcher call.  Use :func:`trace` to capture a
``torch.profiler`` trace and ``tools/trace_capture_torch.py`` to read its
device time by stage.  A captured program's replay enters no range.

**Stage stamps.**  A program run under :func:`stamping` (the detector's
and the segmenter's, through ``pipeline/readback.py::packed_readback``)
writes the card's
``%globaltimer`` into a small int64 buffer at its start and at the start
of each top-level stage group (:data:`STAMPED`), through a one-thread
kernel (``csrc/stamp.cu``) that :func:`stage_range` launches on entry;
the program then stamps once before its readback is packed, and packs the
buffer into that readback.  A CUDA graph captures the launches, so every
replay stamps.  After the readback wait, :func:`record_stamps` adds the
difference of consecutive stamps to the innermost span's owner as
``device.<group>`` ms.  No CUDA event is involved and nothing waits: the
stamps travel in the call's own device-to-host copy.  Off a card nothing
stamps (:func:`stamper` is None there).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Callable, ContextManager, Iterator, Optional

import torch
import torch.autograd as _autograd
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

from ..kernels import build as _build

__all__ = ["DetectTimings", "FpsCounter", "trace", "tracing", "span",
           "stage_range", "stamping", "stamper", "record_stamps"]

#: Chrome-trace categories of device activities.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_NO_RANGE = contextlib.nullcontext()

#: Open :func:`trace` windows, in any thread (see :func:`tracing`).
_traces = 0
_traces_lock = threading.Lock()


class _Local(threading.local):
    """Per thread: ``spans``, the open :class:`span` objects, innermost
    last; ``stamps``, the :class:`_Stamps` of the program running under
    :func:`stamping`.  Set for each thread on its first use, so that a
    read never takes the missing-attribute path."""

    def __init__(self):
        self.spans: list = []
        self.stamps: Optional[_Stamps] = None


_local = _Local()

_perf_counter = time.perf_counter


def tracing() -> bool:
    """Whether a :func:`trace` window is open, in any thread.  Captured
    programs (``pipeline/graphs.py``) then run their eager program, so
    that the trace holds the ``fdt.*`` ranges that a graph's replay does
    not enter."""
    return _traces > 0


def _count_trace(n: int) -> None:
    global _traces
    with _traces_lock:
        _traces += n


def stage_range(name: str) -> ContextManager:
    """``record_function(name)`` while a profiler is running, else a
    context that does nothing; under :func:`stamping`, entering a range
    of :data:`STAMPED` first stamps the card's clock.

    The test reads ``torch.autograd.profiler._is_profiler_enabled``, the
    process-wide flag that every ``torch.profiler.profile`` (and so
    :func:`trace`) sets while it records; a worker thread sees it too, so
    its ranges reach a trace entered on another thread.  A range entered
    before the profiler starts is not recorded."""
    stamps = _local.stamps
    if stamps is not None and name in STAMPED:
        stamps.stamp(STAMPED[name])
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_RANGE


class span:
    """A host span (module docstring): ``with span(name, owner, unit):``.

    ``owner`` is the :class:`DetectTimings` that gets the span's host ms
    and count under ``name``; ``unit`` the call or batch it belongs to.
    Where either is None it is the innermost open span's on this thread
    (the unit only where that span has the same owner); a span with no
    owner anywhere records nothing.  With ``name`` None the span only
    passes its owner and unit to the spans inside it.  While a profiler
    runs, a named span is also the range ``fdt.<name>``, its unit the
    range's one recorded input."""

    __slots__ = ("name", "owner", "unit", "_t0", "_range")

    def __init__(self, name: Optional[str] = None,
                 owner: Optional["DetectTimings"] = None,
                 unit: Optional[int] = None):
        self.name = name
        self.owner = owner
        self.unit = unit

    def __enter__(self) -> "span":
        stack = _local.spans
        if stack and (self.owner is None or self.unit is None):
            up = stack[-1]
            if self.owner is None:
                self.owner = up.owner
            if self.unit is None and up.owner is self.owner:
                self.unit = up.unit
        stack.append(self)
        self._range = None
        if self.name is not None and _autograd_profiler._is_profiler_enabled:
            # A range whose one recorded input is the unit.
            self._range = _autograd._record_function_with_args_enter(
                "fdt." + self.name,
                *(() if self.unit is None else (self.unit,)))
        self._t0 = _perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = _perf_counter() - self._t0
        if self._range is not None:
            _autograd._record_function_with_args_exit(self._range)
        _local.spans.pop()
        owner = self.owner
        if owner is not None and self.name is not None:
            with owner._lock:
                owner.total_ms[self.name] += dt * 1e3
                owner.calls[self.name] += 1


def current_unit(owner: "DetectTimings") -> Optional[int]:
    """The unit of the innermost span open on this thread, where that span
    belongs to ``owner``; else None."""
    stack = _local.spans
    if stack and stack[-1].owner is owner:
        return stack[-1].unit
    return None


class DetectTimings:
    """Accumulates per-stage wall-clock milliseconds across calls: the host
    spans of a detector (:class:`span`) and the device ms of its programs'
    stage groups (``device.<group>``, :func:`record_stamps`)."""

    def __init__(self):
        self.total_ms: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        # A detector is legitimately shared across threads (ServingPipeline
        # worker + owner thread); the += read-modify-writes would drop
        # increments and desync calls from total_ms without this.
        self._lock = threading.Lock()

    def stage(self, name: str) -> span:
        """A span of ``name`` recording into these timings."""
        return span(name, self)

    def mean_ms(self, name: str) -> float:
        n = self.calls.get(name, 0)
        return self.total_ms[name] / n if n else 0.0

    def report(self) -> dict[str, float]:
        """{stage: mean ms} over everything recorded so far."""
        return {k: round(self.mean_ms(k), 3) for k in self.total_ms}

    def reset(self) -> None:
        with self._lock:
            self.total_ms.clear()
            self.calls.clear()

    def __repr__(self) -> str:
        parts = [f"{k}={self.mean_ms(k):.2f}ms" for k in self.total_ms]
        return "DetectTimings(" + ", ".join(parts) + ")"


#: The stage ranges that open a stage group of the detector's programs
#: (and of the segmenter's, ``fdt.segmentation``), and the group's name: a
#: program stamps the card's clock on entering each (and once before its
#: readback is packed, ``"pack"``), so that the groups' device ms are the
#: differences of consecutive stamps.
STAMPED = {"fdt.letterbox": "detect", "fdt.mesh": "mesh",
           "fdt.iris": "iris", "fdt.blendshapes": "blendshapes",
           "fdt.embedding": "embedding", "fdt.segmentation": "segmentation"}
#: Slots of a program's stamp buffer: the groups and the final stamp.
STAMP_SLOTS = 8
_DEVICE_KEYS = {g: "device." + g for g in STAMPED.values()}


def _cuda_stamp(buf, slot: int) -> None:
    """Launches ``csrc/stamp.cu``'s one-thread kernel: ``buf[slot]`` gets
    the card's ``%globaltimer`` (ns) when the stream reaches it."""
    index = buf.device.index
    rc = _build.load().fdt_stage_stamp(buf.data_ptr(), slot, index,
                                       _build.stream(index))
    _build.check(rc, "stage_stamp")


def stamper(device) -> Optional[Callable]:
    """The function that stamps a program's buffer on ``device``,
    ``stamp(buf, slot)``: the kernel's on a card, None elsewhere (nothing
    stamps).  The tests replace this function with a stand-in."""
    return _cuda_stamp if device.type == "cuda" else None


class _Stamps:
    """A program call's stamp buffer and the groups stamped so far."""

    __slots__ = ("buf", "names", "fn")

    def __init__(self, buf, fn: Callable):
        self.buf = buf
        self.names: list[str] = []
        self.fn = fn

    def stamp(self, name: str) -> None:
        if len(self.names) < STAMP_SLOTS:
            self.fn(self.buf, len(self.names))
            self.names.append(name)

    def values(self):
        """The stamped slots, ``[n] int64`` on the device."""
        return self.buf[:len(self.names)]


@contextlib.contextmanager
def stamping(device) -> Iterator[Optional[_Stamps]]:
    """Within the block, on this thread, :func:`stage_range` stamps a
    buffer on ``device`` (:data:`STAMPED`); yields its :class:`_Stamps`,
    or None where ``device`` has no :func:`stamper`.  The caller stamps
    ``"pack"`` last and packs ``values()`` into its readback."""
    fn = stamper(device)
    if fn is None:
        yield None
        return
    saved = _local.stamps
    _local.stamps = stamps = _Stamps(
        torch.empty(STAMP_SLOTS, dtype=torch.int64, device=device), fn)
    try:
        yield stamps
    finally:
        _local.stamps = saved


def record_stamps(names, values) -> None:
    """Adds each stage group's device ms to the owner of the innermost span
    open on this thread as ``device.<group>``: ``names`` the stamps'
    names in order (the last the final stamp), ``values`` their ns (an
    int64 array)."""
    stack = _local.spans
    owner = stack[-1].owner if stack else None
    if owner is None:
        return
    values = values.tolist()
    with owner._lock:
        for name, t0, t1 in zip(names, values, values[1:]):
            key = _DEVICE_KEYS[name]
            owner.total_ms[key] += (t1 - t0) * 1e-6
            owner.calls[key] += 1


class FpsCounter:
    """Sliding-window frames-per-second counter (flutter_litert FpsCounter
    analog, README.md:732) for camera/video loops."""

    def __init__(self, window: int = 30):
        self._times: list[float] = []
        self._window = window

    def tick(self) -> float:
        """Records a frame; returns the current FPS estimate."""
        now = time.perf_counter()
        self._times.append(now)
        if len(self._times) > self._window:
            self._times.pop(0)
        return self.fps

    @property
    def fps(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Captures a ``torch.profiler`` trace of the calls inside the window
    and writes it as a Chrome trace under ``log_dir`` on exit, named as
    ``tensorboard_trace_handler`` names it
    (``<host>_<pid>.<ns>.pt.trace.json``; ``tools/trace_capture*.py`` glob
    for it).

    It records CPU activities, and CUDA activities (kernels, copies, the
    runtime calls that launched them) whenever CUDA is available; ops are
    grouped by input shape, and no Python stacks are taken (they cost a
    lookup an op).  Every thread that runs while the window is open is
    recorded (``profile_all_threads``), so a ``ServingPipeline`` or
    ``ReplicaPool`` worker started before the window reaches the trace.
    Inside the window every program call runs its eager program, op by
    op, in place of its captured CUDA graph (``pipeline/graphs.py``,
    :func:`tracing`), so that the trace holds each op's ``fdt.*`` stage
    range: the trace shows the eager program's launches and gaps, not a
    replay's.  Any other ``torch.profiler`` window records the replays.
    With CUDA, every visible card is synchronised at both ends of the
    window, so every kernel queued inside it, on any card, is in the
    trace, and one empty marker kernel is launched at its start (on the
    current card); a trace that then holds no device
    activity raises RuntimeError on exit (the profiler lost its device
    records): no CPU-only trace is passed off as a whole one."""
    import socket

    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)

    def synchronize_all():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    if cuda:
        synchronize_all()
    with profile(activities=activities, record_shapes=True,
                 with_stack=False, experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        if cuda:
            torch.cuda._sleep(0)  # the marker: one device activity at least
        _count_trace(1)
        try:
            yield
        finally:
            _count_trace(-1)
            if cuda:
                synchronize_all()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if cuda and not _device_activities(path):
        raise RuntimeError(
            f"trace: the profiler recorded no device activity although "
            f"CUDA work ran in the window ({path} holds the CPU side only)")


def _device_activities(path: str) -> int:
    """The count of device activities (kernels, copies, memsets) in the
    Chrome trace at ``path``."""
    import json
    with open(path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") in DEVICE_CATEGORIES)
