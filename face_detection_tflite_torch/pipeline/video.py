"""Video-file and camera-stream processing.

Port of the JAX package's ``pipeline/video.py``, the analog of the
reference's `detectFacesFromVideo` (`face_detector.dart`) and
flutter_litert's `FrameThrottle` (README.md:734-761): video frames go
through the detector in batches, while tracking is applied per frame in
stream order on the host; ``devices=`` spreads the batches over a
``ReplicaPool``.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from ..utils.image import fit_max_dim
from .config import FaceDetectionMode
from .types import Face

__all__ = ["VideoFrameResult", "process_video", "FrameThrottle"]


@dataclasses.dataclass
class VideoFrameResult:
    frame_index: int
    timestamp_s: float
    faces: list[Face]


def _read_frames(path: str, frame_stride: int, max_frames: Optional[int],
                 max_dim: Optional[int] = None):
    """Yields ``(frame index, timestamp s, RGB frame)`` of every
    ``frame_stride``-th frame, at most ``max_frames`` of them, each
    downscaled to ``max_dim``.  The BGR-to-RGB conversion is a contiguous
    copy made here, on the prefetch thread (``cv2.cvtColor`` releases the
    interpreter lock), where the JAX reader yields a negative-stride view:
    the consumer's ``np.stack`` then copies contiguous frames, where it
    copied such views element by element (about 70 ms a batch of eight
    720p frames on an H100 machine's host, PERF.md)."""
    import cv2
    if frame_stride < 1:
        raise ValueError(f"frame_stride must be >= 1, got {frame_stride}")
    if max_frames is not None and max_frames <= 0:
        return  # a zero or negative budget yields nothing
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video: {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    idx = 0
    emitted = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % frame_stride == 0:
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if max_dim is not None and max_dim > 0:
                    rgb = fit_max_dim(rgb, max_dim)
                yield idx, idx / fps, rgb
                emitted += 1
                if max_frames is not None and emitted >= max_frames:
                    break
            idx += 1
    finally:
        cap.release()


def process_video(detector, path: str,
                  mode: FaceDetectionMode = FaceDetectionMode.FULL,
                  *, frame_stride: int = 1, batch_size: int = 8,
                  max_frames: Optional[int] = None,
                  max_dim: Optional[int] = None,
                  devices: Optional[list] = None
                  ) -> Iterator[VideoFrameResult]:
    """Runs ``detector`` over a video file, ``batch_size`` frames a
    ``detect_faces_batch`` call, and yields one :class:`VideoFrameResult`
    a frame, in frame order.  Temporal tracking (where the detector has it
    enabled) is applied afterwards in frame order, with the tracking
    generation read before each batch, so a ``reset_tracking`` during a
    batch leaves that batch's faces without IDs.  ``max_dim`` downscales
    each frame so its longer side fits (face coordinates are then in the
    downscaled frame).

    The host decode runs on a prefetch thread feeding a bounded queue:
    cv2's decode and the wait for the device both release the interpreter
    lock, so the next batch's decode overlaps this batch's device work.
    A consumer that stops iterating stops the reader, which releases the
    capture; a reader error is raised on the consumer.

    ``devices`` spreads consecutive batches round-robin over a
    ``ReplicaPool`` of them: up to ``len(devices) + 1`` batches are in
    flight while the results, and so the tracking, still come in frame
    order (detection is stateless; tracking is attached on the host after
    each batch, in order)."""
    stop = threading.Event()
    q: queue.Queue = queue.Queue(maxsize=max(2 * batch_size, 2))
    reader_error: list[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _reader():
        try:
            for item in _read_frames(path, frame_stride, max_frames,
                                     max_dim):
                if not _put(item):
                    return
        except BaseException as e:  # raised again on the consumer's thread
            reader_error.append(e)
        finally:
            _put(None)

    pool = None
    inflight: collections.deque = collections.deque()
    if devices:
        # Before the reader starts: a pool that fails to build (a
        # data_parallel detector) must not leave a reader thread behind.
        from ..parallel.replica import ReplicaPool
        pool = ReplicaPool(detector, devices=devices, mode=mode)
    max_inflight = len(devices) + 1 if devices else 1

    thread = threading.Thread(target=_reader, daemon=True,
                              name="fdt-video-prefetch")
    thread.start()
    pending: list[tuple[int, float, np.ndarray]] = []

    def emit(metas, gen0, per_frame):
        for (fi, ts), faces in zip(metas, per_frame):
            yield VideoFrameResult(fi, ts,
                                   detector._attach_tracking(faces, gen0))

    def drain_oldest():
        metas, gen0, fut = inflight.popleft()
        yield from emit(metas, gen0, fut.result())

    def flush():
        if not pending:
            return
        gen0 = detector._tracking_generation  # read before the batch
        batch = np.stack([f for _, _, f in pending])
        metas = [(fi, ts) for fi, ts, _ in pending]
        pending.clear()
        if pool is not None:
            inflight.append((metas, gen0, pool.submit(batch)))
            while len(inflight) > max_inflight:
                yield from drain_oldest()
            return
        yield from emit(metas, gen0, detector.detect_faces_batch(batch, mode))

    try:
        while True:
            item = q.get()
            if item is None:
                break
            pending.append(item)
            if len(pending) >= batch_size:
                yield from flush()
        if reader_error:
            raise reader_error[0]
        yield from flush()
        while inflight:
            yield from drain_oldest()
    finally:
        stop.set()
        if pool is not None:
            pool.close(wait=False)


class FrameThrottle:
    """Drop-oldest frame queue for live camera streams.

    Analog of flutter_litert's FrameThrottle: producers push frames at
    camera rate; the consumer always processes the freshest frame and
    stale frames are dropped rather than queued (bounded latency).
    """

    def __init__(self, maxlen: int = 1):
        self._dq: collections.deque = collections.deque(maxlen=maxlen)
        self._cv = threading.Condition()
        self._closed = False
        self.dropped = 0
        self.submitted = 0

    def submit(self, frame) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("FrameThrottle is closed")
            if len(self._dq) == self._dq.maxlen:
                self.dropped += 1
            self._dq.append(frame)
            self.submitted += 1
            self._cv.notify()

    def take(self, timeout: Optional[float] = None):
        """Blocks for the freshest frame; returns None on close/timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._dq and not self._closed:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    break
                if not self._cv.wait(remaining):
                    break  # timed out
            if not self._dq:
                return None
            frame = self._dq.pop()  # freshest
            self.dropped += len(self._dq)
            self._dq.clear()
            return frame

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
