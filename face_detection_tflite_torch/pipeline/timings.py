"""Per-stage timing instrumentation.

Analog of the reference's stopwatch instrumentation: `WebDetectTimings`
(`face_detector_web.dart:33-57`, per-stage µs gated on `debugTimings`) and
the detect/segment stage stopwatches (`face_detector.dart:1303-1316`).
Stage boundaries here are the host-visible ones of the speculative
dispatch (program, overflow face stages, readback); kernel-level
attribution is the job of ``torch.profiler`` or CUDA events.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Iterator

__all__ = ["DetectTimings", "FpsCounter"]


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
