"""Per-stage timing instrumentation.

Analog of the reference's stopwatch instrumentation: `WebDetectTimings`
(`face_detector_web.dart:33-57`, per-stage µs gated on `debugTimings`) and
the detect/segment stage stopwatches (`face_detector.dart:1303-1316`).
Stage boundaries here are the host-visible ones of the speculative
dispatch (program, overflow face stages, readback).  Inside a program,
each stage runs in a ``torch.profiler.record_function`` range of a fixed
name (``fdt.letterbox``, ``fdt.detector``, ``fdt.postprocess``,
``fdt.mesh``, ``fdt.iris``, ``fdt.blendshapes``, ``fdt.refine``,
``fdt.embedding``; ``fdt.upload`` and ``fdt.pack`` around the batch's
upload and readback, ``fdt.segmentation`` and ``fdt.embed`` around the
segmenter's and ``FaceEmbedding``'s own calls), the counterpart of the
op metadata that ties XLA's fusions to the JAX package's stage
functions; use
:func:`trace` to capture a ``torch.profiler`` trace and
``tools/trace_capture_torch.py`` to read its device time by stage.  The
ranges are entered through :func:`stage_range`, which enters one only
while a profiler is running, so that a call outside a trace pays a flag
read a stage and not ``record_function``'s dispatcher call.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import ContextManager, Iterator

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["DetectTimings", "FpsCounter", "trace", "tracing"]

#: Chrome-trace categories of device activities.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_NO_RANGE = contextlib.nullcontext()

#: Open :func:`trace` windows, in any thread (see :func:`tracing`).
_traces = 0
_traces_lock = threading.Lock()


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
    context that does nothing.

    The test reads ``torch.autograd.profiler._is_profiler_enabled``, the
    process-wide flag that every ``torch.profiler.profile`` (and so
    :func:`trace`) sets while it records; a worker thread sees it too, so
    its ranges reach a trace entered on another thread.  A range entered
    before the profiler starts is not recorded."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_RANGE


class DetectTimings:
    """Accumulates per-stage wall-clock milliseconds across calls."""

    def __init__(self):
        self.total_ms: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        # A detector is legitimately shared across threads (ServingPipeline
        # worker + owner thread); the += read-modify-writes would drop
        # increments and desync calls from total_ms without this.
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self.total_ms[name] += dt
                self.calls[name] += 1

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

    import torch
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
