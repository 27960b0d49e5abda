"""HTTP serving front end over a FaceDetector on the card.

Port of the JAX package's ``pipeline/server.py``: a stdlib-only threaded
HTTP server whose detect endpoint funnels concurrent requests through a
micro-batching aggregator (requests decoded on their handler threads,
grouped by image shape and mode within a small window, executed as one
batch through a ``ServingPipeline``, whose worker overlaps the next
micro-batch's upload and program with this one's readback).  With
``devices=[...]`` (the command line's ``--replicas N``) the micro-batches
go round-robin over a ``ReplicaPool`` of pinned pipelines, one a device.

Endpoints
---------
- ``GET  /healthz``                      liveness + readiness
- ``GET  /v1/info``                      model version, accelerator and
                                         memory reports
- ``GET  /metrics``                      Prometheus text format
- ``POST /v1/detect``                    image bytes -> faces JSON
    query: ``mode=fast|standard|full`` (default standard), plus opt-in
    payload flags ``mesh=1 contours=1 iris=1 embedding=1``
- ``POST /v1/embed``                     image bytes -> per-face
    embeddings (detects at standard mode first)
- ``POST /v1/segment``                   image bytes -> mask JSON
    query: ``format=uint8|float32|binary`` (default uint8),
    ``upsample=1`` (to the image's size)
- ``POST /v1/detect_with_segmentation``  image bytes -> faces and mask
    (the mask program queued before the detection)

Bodies are raw encoded image bytes (JPEG/PNG/WebP).  Responses are JSON;
errors are ``{"error": ...}`` with a 4xx/5xx status.  Deliberate
differences from the JAX server: ``_AdaptiveCap`` evicts the least
recently updated executor stream and computes a completion's interval
under its lock; ``/v1/embed``'s ``pretrained`` is the detector's
``is_embedding_pretrained``.  Start one with::

    server = FaceServer(detector)
    server.start()          # binds; server.port is the bound port
    ...
    server.close()
"""

from __future__ import annotations

import base64
import json
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .config import FaceDetectionMode
from .serving import ServingPipeline
from ..utils.image import decode_image
from ..utils.metrics import MetricsRegistry

__all__ = ["FaceServer", "ServerOverloaded"]

_MODES = {"fast": FaceDetectionMode.FAST,
          "standard": FaceDetectionMode.STANDARD,
          "full": FaceDetectionMode.FULL}

MAX_BODY_BYTES = 32 * 1024 * 1024


class ServerOverloaded(RuntimeError):
    """The bounded request queue is full: the server sheds this request
    (HTTP 503 + Retry-After) instead of queueing without bound — under
    sustained overload an unbounded queue grows RSS and every queued
    request's latency monotonically, and nothing ever recovers."""


class _AdaptiveCap:
    """Steers the micro-batch drain cap to the throughput-optimal size.

    The best cap depends on the host-to-device attachment: where uploads
    amortize, large batches win; where the per-image upload cost is
    constant, drains past the compute-amortization point add latency and
    convoy the server.  Rather than ask deployments to tune ``max_batch``,
    this keeps an EWMA of per-image completion seconds per ladder bucket
    and caps drains at the largest bucket within ``tolerance`` of the best
    observed, climbing one unexplored ladder step at a time and re-probing
    the neighbours of the cap every ``explore_every`` records.

    The per-image figure must be service time, not sojourn time: under
    overload an executor's queue wait dominates the sojourn and is
    amortized over the batch, so bigger batches would always look cheaper
    (a positive feedback to the convoying maximum).
    :meth:`record_completion` therefore uses the completion-gap rule: a
    batch's service interval starts at the later of its submit time and
    the previous completion on the same executor stream.

    Thread-safe; ``record``/``record_completion`` run on batcher and
    pipeline-worker threads and ``cap`` on the batcher thread.
    """

    LADDER = (1, 2, 4, 8, 16, 32, 64, 128)
    #: An unexplored step above steady is offered eagerly so
    #: amortization is discovered fast — but only this many consecutive
    #: times without a record landing in it.  Traffic that can't fill
    #: the probe (mixed shapes split the drain; light load) must not
    #: leave the effective cap pinned one step above steady forever.
    MAX_UNANSWERED_OFFERS = 8

    def __init__(self, max_batch: int, alpha: float = 0.3,
                 tolerance: float = 1.25, explore_every: int = 50):
        self._ladder = [b for b in self.LADDER if b <= max_batch]
        if not self._ladder or self._ladder[-1] != max_batch:
            self._ladder.append(max_batch)
        self._alpha = alpha
        self._tol = tolerance
        self._explore_every = explore_every
        self._ewma: dict = {}       # ladder bucket -> per-image seconds
        self._last_done: dict = {}  # executor stream -> last completion t
        self._since_explore = 0
        self._offers: dict = {}     # bucket -> unanswered eager offers
        self._explore_dir = -1      # flipped before use: first probe up
        self._lock = threading.Lock()

    def _bucket(self, n: int) -> int:
        b = self._ladder[0]
        for step in self._ladder:
            if step <= n:
                b = step
        return b

    def record(self, n_images: int, seconds: float) -> None:
        """Feed one batch execution whose ``seconds`` is true service
        time (the synchronous detect path: no queueing inside it)."""
        with self._lock:
            self._record_locked(n_images, seconds)

    def _record_locked(self, n_images: int, seconds: float) -> None:
        """:meth:`record`'s update; the caller holds the lock."""
        if n_images <= 0 or seconds <= 0.0:
            return
        per_image = seconds / n_images
        b = self._bucket(n_images)
        prev = self._ewma.get(b)
        self._ewma[b] = (per_image if prev is None else
                         prev + self._alpha * (per_image - prev))
        self._since_explore += 1
        self._offers.pop(b, None)   # the probe got its answer

    def record_completion(self, n_images: int, t_submit: float,
                          t_done: float, stream=None) -> None:
        """Feed one batch that completed through a pipelined executor.

        Queue wait inside the executor must not count as per-image cost
        (see class docstring: sojourn/batch amortizes wait and inflates
        large buckets), so the service interval is
        ``t_done - max(last completion on this stream, t_submit)``.
        ``stream`` identifies the executor, so that two executors'
        completions do not truncate each other's intervals.  The interval
        is computed and recorded under the lock: two completions of one
        stream cannot read the same previous completion.
        """
        with self._lock:
            last = self._last_done.get(stream)
            if last is not None and t_done <= last:
                return              # out-of-order/duplicate completion
            # Re-inserted, so the table is ordered by last update and the
            # eviction below drops the least recently updated stream.
            self._last_done.pop(stream, None)
            self._last_done[stream] = t_done
            if len(self._last_done) > 128:
                # Worker recycles mint new executor objects (new stream
                # ids); the table stays bounded.
                self._last_done.pop(next(iter(self._last_done)))
            start = t_submit if last is None else max(last, t_submit)
            self._record_locked(n_images, t_done - start)

    def _steady(self) -> int:
        """Largest ladder bucket within tolerance of the best EWMA.
        Caller holds the lock."""
        if not self._ewma:
            return self._ladder[-1]
        best = min(self._ewma.values())
        allowed = [b for b in self._ladder
                   if b in self._ewma
                   and self._ewma[b] <= best * self._tol]
        return max(allowed) if allowed else self._bucket(
            min(self._ewma, key=self._ewma.get))

    @property
    def cap(self) -> int:
        """Drain cap for the NEXT micro-batch.  Reading it consumes
        explore triggers (probes one ladder step above/below steady),
        so only the batcher's drain loop should read it —
        observability uses the side-effect-free :meth:`peek`.

        Cold start allows a full drain (request consolidation must work
        from the first batch), and UNSAMPLED neighbors of the steady
        bucket are explored eagerly in BOTH directions: upward so
        amortization is discovered, and downward so a server that came
        up under sustained overload — where every drain fills to
        max_batch and only that bucket gets sampled — descends to the
        knee within a few drains instead of sitting in the measured
        convoy collapse with nothing below ever tried."""
        with self._lock:
            if not self._ewma:
                return self._ladder[-1]
            hi = self._steady()
            above = [b for b in self._ladder if b > hi]
            below = [b for b in self._ladder if b < hi]
            # Eager exploration of unsampled neighbors (up first, then
            # down), each bounded — see MAX_UNANSWERED_OFFERS.
            for probe in ((above[0] if above else None),
                          (below[-1] if below else None)):
                if probe is not None and probe not in self._ewma:
                    offered = self._offers.get(probe, 0)
                    if offered < self.MAX_UNANSWERED_OFFERS:
                        self._offers[probe] = offered + 1
                        return probe
            # Periodic refresh: alternate one step above (a recovered
            # link re-opens larger batches) and one step below (a
            # degraded link, or a small bucket polluted by a
            # cold-compile outlier, is re-measured — descent must stay
            # reachable).
            if self._since_explore >= self._explore_every:
                self._since_explore = 0
                self._explore_dir = -self._explore_dir
                if self._explore_dir > 0 and above:
                    return above[0]
                if below:
                    return below[-1]
                if above:
                    return above[0]
            return hi

    def peek(self) -> int:
        """The steady cap, without consuming an explore trigger (the
        /metrics gauge reads this; a gauge read must not swallow the
        probe that would have steered a real drain)."""
        with self._lock:
            return (self._ladder[-1] if not self._ewma
                    else self._steady())

    def snapshot(self) -> dict:
        """Per-bucket EWMA (seconds/image) — for /metrics and tests."""
        with self._lock:
            return dict(self._ewma)


class _Batcher:
    """Groups concurrent detect requests into batched program calls.

    One dispatch thread owns the detector's detect path.  Requests queue
    as (image, mode, flags, Future); the thread drains whatever arrived
    within ``window_ms`` of the first item (capped at ``max_batch``),
    groups by (image shape, mode), and submits one batched execution per
    group — through ``pool_for_mode``'s executor (a ServingPipeline or
    a ReplicaPool; groups dispatch asynchronously and overlap) when given,
    else a synchronous ``detect_faces_batch`` on this thread.  A lone
    request therefore waits at most ``window_ms``; concurrent same-shape
    requests ride one program execution.

    ``max_queue`` > 0 bounds the waiting-request queue: a submit against
    a full queue raises :class:`ServerOverloaded` (backpressure) rather
    than growing the backlog without bound.  ``on_drain(n_groups)`` is
    called on the dispatch thread after each drain's groups are
    submitted — the FaceServer recycle hook (no group of THIS thread is
    mid-flight there).
    """

    def __init__(self, detector, window_ms: float = 4.0,
                 max_batch: int = 16, metrics: Optional[dict] = None,
                 pool_for_mode=None, max_queue: int = 0, on_drain=None,
                 adaptive_cap: Optional[_AdaptiveCap] = None):
        import queue
        self._det = detector
        self._window_s = window_ms / 1000.0
        self._max_batch = max_batch
        #: Optional attachment-aware drain cap (see _AdaptiveCap): when
        #: set, drains stop at min(max_batch, adaptive_cap.cap) and every
        #: group execution's (size, duration) feeds the estimator.
        self._adaptive = adaptive_cap
        self._q: "queue.Queue" = queue.Queue(maxsize=max(0, max_queue))
        self._metrics = metrics or {}
        #: Optional mode -> executor resolver: shape-groups are then
        #: submitted to the executor (non-blocking; member futures resolve
        #: from its future's callback) instead of running
        #: detect_faces_batch on this thread.
        self._pool_for_mode = pool_for_mode
        self._on_drain = on_drain
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fdt-batcher")
        self._thread.start()

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    def submit(self, image: np.ndarray, mode: FaceDetectionMode) -> Future:
        import queue
        if self._closed:
            raise RuntimeError("server is closed")
        fut: Future = Future()
        try:
            self._q.put_nowait((image, mode, fut))
        except queue.Full:
            raise ServerOverloaded(
                f"request queue full ({self._q.maxsize} waiting); "
                "retry later") from None
        return fut

    def close(self):
        import queue
        self._closed = True
        while True:
            try:
                self._q.put(None, timeout=1.0)
                break
            except queue.Full:
                if not self._thread.is_alive():
                    # The worker died (it should be unkillable — this is
                    # a last-resort guard): nothing will ever drain the
                    # full queue, so resolve the stragglers here instead
                    # of spinning forever.
                    break
                continue  # the worker is draining; space frees up
        self._thread.join(timeout=10)
        if not self._thread.is_alive():
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not None and not item[2].cancelled():
                    item[2].set_exception(RuntimeError("server closed"))

    def _drain(self, first):
        """First item + everything arriving within the window."""
        import queue
        items = [first]
        limit = self._max_batch
        if self._adaptive is not None:
            limit = min(limit, self._adaptive.cap)
        deadline = time.monotonic() + self._window_s
        while len(items) < limit:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # keep the shutdown sentinel visible
                break
            items.append(nxt)
        return items

    def _run(self):
        while True:
            first = self._q.get()
            if first is None:
                break
            items = self._drain(first)
            # With a bucket_images detector, MIXED-size requests sharing a
            # size bucket consolidate into ONE padded batch (per-image
            # true sizes ride along for the coordinate rescale); exact
            # shapes group separately otherwise.
            bfn = (self._det._bucket
                   if getattr(self._det, "bucket_images", False) else None)
            groups: dict = {}
            for img, mode, fut in items:
                try:
                    # Per-item: a submission without a usable .shape
                    # (unreachable via HTTP, where decode_image
                    # guarantees HxWx3, but direct _Batcher callers are
                    # arbitrary) must fail ITS future, not kill this
                    # thread and wedge every later request.
                    key = (((bfn(img.shape[0]), bfn(img.shape[1])), mode)
                           if bfn else (img.shape, mode))
                except Exception as e:  # noqa: BLE001
                    if not fut.cancelled():
                        fut.set_exception(e)
                    continue
                groups.setdefault(key, []).append((img, fut))
            for (shape, mode), members in groups.items():
                # The padding/stacking consolidation lives INSIDE the try:
                # a malformed member (wrong rank/channels — unreachable via
                # HTTP where decode_image guarantees HxWx3, but this thread
                # must survive any caller) resolves that group's futures
                # with the exception instead of killing the dispatch thread
                # and wedging every later request.
                try:
                    sizes = None
                    if bfn:
                        kh, kw = shape
                        imgs = np.stack([
                            np.pad(m[0], ((0, kh - m[0].shape[0]),
                                          (0, kw - m[0].shape[1]), (0, 0)))
                            for m in members])
                        sizes = [(m[0].shape[1], m[0].shape[0])
                                 for m in members]
                    else:
                        imgs = np.stack([m[0] for m in members])
                    hist = self._metrics.get("batch_size")
                    if hist is not None:
                        hist.observe(len(members))
                    if self._pool_for_mode is not None:
                        pool = self._pool_for_mode(mode)
                        t0 = time.perf_counter()
                        pool.submit(
                            imgs, orig_sizes=sizes).add_done_callback(
                                lambda pf, members=members, t0=t0,
                                stream=id(pool):
                                    _resolve_group(pf, members,
                                                   self._adaptive, t0,
                                                   stream))
                        continue  # resolves asynchronously
                    t0 = time.perf_counter()
                    results = (self._det.detect_faces_batch(
                        imgs, mode, _orig_sizes=sizes) if sizes else
                        self._det.detect_faces_batch(imgs, mode))
                    if self._adaptive is not None:
                        self._adaptive.record(len(members),
                                              time.perf_counter() - t0)
                except Exception as e:  # noqa: BLE001 — resolve futures
                    for _, fut in members:
                        if not fut.cancelled():
                            fut.set_exception(e)
                    continue
                for (_, fut), faces in zip(members, results):
                    if not fut.cancelled():
                        fut.set_result(faces)
            if self._on_drain is not None:
                try:
                    self._on_drain(len(groups))
                except Exception:  # noqa: BLE001 — the recycle hook must
                    pass           # never kill the dispatch thread
        # resolve anything still queued after shutdown
        import queue
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[2].cancelled():
                item[2].set_exception(RuntimeError("server closed"))


def _resolve_group(pool_future: Future, members, adaptive=None,
                   t0: float = 0.0, stream=None) -> None:
    """Fans an executor's batch result out to its member request
    futures (runs on the pipeline worker thread that finished it)."""
    err = pool_future.exception()
    if err is not None:
        for _, fut in members:
            if not fut.cancelled():
                fut.set_exception(err)
        return
    if adaptive is not None:
        # completion-gap service time, NOT submit->done: sojourn would
        # amortize executor queue wait over the batch and teach the cap
        # to convoy (see _AdaptiveCap docstring).  The future's own
        # fdt_stream (stamped by the ServingPipeline that ran it) names
        # the executor stream: under a ReplicaPool each replica's
        # pipeline keeps its own completion stream.
        adaptive.record_completion(len(members), t0,
                                   time.perf_counter(),
                                   getattr(pool_future, "fdt_stream",
                                           stream))
    for (_, fut), faces in zip(members, pool_future.result()):
        if not fut.cancelled():
            fut.set_result(faces)


def _flag(q: dict, name: str) -> bool:
    v = q.get(name, ["0"])[0].lower()
    return v in ("1", "true", "yes")


def _process_rss_mb() -> float:
    """Resident set size of this process in MB (Linux /proc; 0.0 where
    unavailable — pass an explicit rss_probe there)."""
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return 0.0


class FaceServer:
    """Threaded HTTP server over a FaceDetector.

    ``detector`` runs without tracking (HTTP requests have no frame
    ordering); ``/v1/embed`` loads the embedding model at first use, as
    the detector's own methods do.
    """

    def __init__(self, detector, host: str = "127.0.0.1", port: int = 0,
                 batch_window_ms: float = 4.0, max_batch: int = 16,
                 devices=None, max_queue: int = 128,
                 recycle_after_batches: Optional[int] = None,
                 max_rss_mb: Optional[float] = None, rss_probe=None,
                 adaptive_batch: bool = True):
        #: ``max_batch`` caps each micro-batch drain.  With
        #: ``adaptive_batch`` (default True) it is an upper bound and the
        #: drain cap is steered to the throughput-optimal ladder bucket
        #: (_AdaptiveCap); pass False to always drain to ``max_batch``.
        self._det = detector
        self._host = host
        self._requested_port = port
        #: Backpressure bound: at most ``max_queue`` decoded requests wait
        #: for the batcher (0 = unbounded).  Beyond it, detect/embed
        #: requests are shed with HTTP 503 + Retry-After instead of
        #: queueing without bound: overload then costs the shed requests
        #: only, while accepted ones keep bounded latency.
        self._max_queue = max_queue
        #: Worker-recycle knobs for long-running deployments: after
        #: ``recycle_after_batches`` batched executions, or whenever
        #: ``rss_probe()`` (default: /proc/self/status VmRSS, in MB)
        #: exceeds ``max_rss_mb``, the serving executors are drained and
        #: rebuilt between micro-batches and the detector's cached frame
        #: buffers dropped; the listener stays up and the built programs
        #: persist, so the next request recreates executors in
        #: milliseconds.
        self._recycle_after = recycle_after_batches
        self._max_rss_mb = max_rss_mb
        self._rss_probe = rss_probe or _process_rss_mb
        self._batches_since_recycle = 0
        #: Replica serving: with ``devices`` (a sequence of devices, one
        #: may repeat), each micro-batched shape-group goes to a
        #: per-device pinned pipeline of a ReplicaPool (round-robin,
        #: ``parallel/replica.py``) instead of one pipeline on the
        #: detector's device.  Pools are made per mode at first use.
        self._devices = list(devices) if devices else None
        if self._devices and getattr(detector, "_mesh", None) is not None:
            raise ValueError(
                "devices= replica serving cannot wrap a data_parallel "
                "detector (it shards each batch across the mesh instead)")
        self._pools: dict = {}
        self._pools_lock = threading.Lock()
        self._pools_closed = False
        self.registry = MetricsRegistry()
        m = self.registry
        self._m_requests = m.counter(
            "fdt_requests_total", "HTTP requests by endpoint and status",
            ("endpoint", "status"))
        self._m_latency = m.histogram(
            "fdt_request_latency_ms", "End-to-end request latency",
            ("endpoint",))
        self._m_batch = m.histogram(
            "fdt_detect_batch_size", "Images per batched detect execution",
            buckets=(1, 2, 4, 8, 16, 32, 64))
        self._m_faces = m.counter(
            "fdt_faces_detected_total", "Total faces returned")
        self._m_inflight = m.gauge(
            "fdt_requests_inflight", "Requests currently being handled")
        self._m_queue = m.gauge(
            "fdt_detect_queue_depth", "Requests waiting for the batcher")
        self._m_shed = m.counter(
            "fdt_requests_shed_total",
            "Requests shed with 503 (bounded queue full)")
        self._m_recycles = m.counter(
            "fdt_worker_recycles_total",
            "Serving-executor recycles (RSS bound / batch count)")
        self._m_rss = m.gauge(
            "fdt_process_rss_mb", "Process resident set size (MB)")
        self._m_cap = m.gauge(
            "fdt_adaptive_batch_cap",
            "Current adaptive micro-batch drain cap (0 = fixed)")
        self._adaptive_cap = (_AdaptiveCap(max_batch)
                              if adaptive_batch and max_batch > 1 else None)
        self._batcher = _Batcher(
            detector, batch_window_ms, max_batch,
            metrics={"batch_size": self._m_batch},
            pool_for_mode=self._executor_for_mode,
            max_queue=max_queue, on_drain=self._on_drain,
            adaptive_cap=self._adaptive_cap)
        # Non-batched detector entry points (embed; the segmentation
        # routes) are serialized against each other; the detect path is
        # owned by the batcher thread.
        self._direct_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None

    def _executor_for_mode(self, mode: FaceDetectionMode):
        """Lazy per-mode batch executor: a ReplicaPool over ``devices``
        for replica serving, else a ServingPipeline on the detector's
        device.  Either way the batcher's shape-groups dispatch
        asynchronously (futures resolve from the executor's worker), so
        micro-batch N+1's upload and program overlap micro-batch N's
        readback instead of serializing on the batcher thread."""
        with self._pools_lock:
            if self._pools_closed:
                # A batcher thread that outlived close()'s join timeout
                # must not create an executor nobody will ever shut
                # down; the error resolves that group's request futures.
                raise RuntimeError("server is closed")
            ex = self._pools.get(mode)
            if ex is None:
                if self._devices:
                    from ..parallel.replica import ReplicaPool
                    ex = ReplicaPool(self._det, devices=self._devices,
                                     mode=mode)
                else:
                    ex = ServingPipeline(self._det, mode, depth=2)
                self._pools[mode] = ex
            return ex

    # -- worker recycle ---------------------------------------------------------

    def _on_drain(self, n_groups: int) -> None:
        """Batcher-thread hook after each drain's groups: updates the
        queue/RSS gauges and recycles the serving executors when a bound
        is crossed.  Runs between micro-batches on the dispatch thread,
        so no group of this thread is mid-flight; executor close() drains
        any asynchronously dispatched batches before returning."""
        self._batches_since_recycle += n_groups
        self._m_queue.set(self._batcher.queue_depth)
        self._m_cap.set(float(self._adaptive_cap.peek())
                        if self._adaptive_cap is not None else 0.0)
        rss = None
        if self._max_rss_mb is not None:
            rss = float(self._rss_probe())
            self._m_rss.set(rss)
        if ((self._recycle_after is not None
             and self._batches_since_recycle >= self._recycle_after)
                or (rss is not None and rss > self._max_rss_mb)):
            self.recycle()

    def recycle(self) -> None:
        """Drains and rebuilds the serving executors; the HTTP listener
        stays up.

        In-flight executor batches finish (their close() joins the
        worker), queued requests are untouched (they re-create executors
        lazily on the next drain), the weights stay on the device and the
        programs in the detector's cache, so a recycle costs one executor
        rebuild, not a rebuild of the programs.  Also drops the detector's
        one-entry decode and upload caches."""
        with self._pools_lock:
            if self._pools_closed:
                return
            pools, self._pools = list(self._pools.values()), {}
        for pool in pools:
            pool.close()
        det = self._det
        det._devput_cache = None
        det._decode_cache = None
        self._batches_since_recycle = 0
        self._m_recycles.inc()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FaceServer":
        handler = self._make_handler()
        self._httpd = ThreadingHTTPServer((self._host, self._requested_port),
                                          handler)
        self._httpd.daemon_threads = True
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="fdt-http")
        self._serve_thread.start()
        return self

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        return f"http://{self._host}:{self.port}"

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._batcher.close()
        with self._pools_lock:
            self._pools_closed = True
            pools, self._pools = list(self._pools.values()), {}
        for pool in pools:  # after the batcher: no new submissions
            pool.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- endpoint implementations (return (status, payload dict)) -------------

    def _do_detect(self, body: bytes, q: dict):
        mode_name = q.get("mode", ["standard"])[0].lower()
        if mode_name not in _MODES:
            return 400, {"error": f"unknown mode {mode_name!r}; "
                                  f"expected one of {sorted(_MODES)}"}
        img = decode_image(body)
        # Bounded wait: a first batch builds kernels and cuDNN plans, but
        # a hung device must surface as an error, not a stuck connection.
        faces = self._batcher.submit(img, _MODES[mode_name]).result(
            timeout=600)
        self._m_faces.inc(len(faces))
        return 200, {
            "faces": [f.to_dict(include_mesh=_flag(q, "mesh"),
                                include_contours=_flag(q, "contours"),
                                include_iris=_flag(q, "iris"),
                                include_embedding=_flag(q, "embedding"))
                      for f in faces],
            "image": {"width": img.shape[1], "height": img.shape[0]},
            "mode": mode_name,
            "model_version": self._det.MODEL_VERSION,
        }

    def _mask_payload(self, mask, q: dict) -> dict:
        fmt = q.get("format", ["uint8"])[0]
        if fmt not in ("float32", "uint8", "binary"):
            return {"error": f"unknown mask format {fmt!r}"}
        if _flag(q, "upsample"):
            mask = mask.upsample()
        d = mask.serialize(fmt=fmt)
        payload = {k: v for k, v in d.items()
                   if k not in ("data", "class_data")}
        payload["padding"] = list(payload["padding"])
        payload["data_b64"] = base64.b64encode(d["data"]).decode("ascii")
        if "class_data" in d:
            payload["class_data_b64"] = base64.b64encode(
                d["class_data"]).decode("ascii")
        return payload

    def _do_segment(self, body: bytes, q: dict):
        with self._direct_lock:
            mask = self._det.get_segmentation_mask_from_bytes(body)
        payload = self._mask_payload(mask, q)
        if "error" in payload:
            return 400, payload
        return 200, {"mask": payload}

    def _do_embed(self, body: bytes, q: dict):
        img = decode_image(body)
        faces = self._batcher.submit(
            img, FaceDetectionMode.STANDARD).result(timeout=600)
        with self._direct_lock:
            embs = self._det.get_face_embeddings(faces, img)
        # The detector's own flag: a detector that acknowledged untrained
        # weights (allow_untrained_embeddings) warns nothing, and its
        # embeddings are untrained all the same.
        pretrained = self._det.is_embedding_pretrained
        out = []
        for f, e in zip(faces, embs):
            b = f.bounding_box
            out.append({
                "bounding_box": {"xmin": float(b.xmin), "ymin": float(b.ymin),
                                 "xmax": float(b.xmax), "ymax": float(b.ymax)},
                "score": float(f.score),
                "embedding": None if e is None
                else [float(v) for v in e]})
        return 200, {"faces": out, "pretrained": pretrained}

    def _do_detect_with_segmentation(self, body: bytes, q: dict):
        mode_name = q.get("mode", ["standard"])[0].lower()
        if mode_name not in _MODES:
            return 400, {"error": f"unknown mode {mode_name!r}"}
        with self._direct_lock:
            faces, mask = self._det.detect_faces_with_segmentation_from_bytes(
                body, _MODES[mode_name])
        payload = self._mask_payload(mask, q)
        if "error" in payload:
            return 400, payload
        self._m_faces.inc(len(faces))
        return 200, {
            "faces": [f.to_dict(include_mesh=_flag(q, "mesh"),
                                include_contours=_flag(q, "contours"),
                                include_iris=_flag(q, "iris"))
                      for f in faces],
            "mask": payload,
            "mode": mode_name,
        }

    def _do_info(self):
        det = self._det
        return 200, {
            "model_version": det.MODEL_VERSION,
            "modes": sorted(_MODES),
            "accelerator_report": det.accelerator_report,
            "memory_report": det.memory_report(),
            "ready": det.is_ready,
            "embedding_ready": det.is_embedding_ready,
            # False = random-init MobileFaceNet weights (embeddings cannot
            # discriminate identities).  Mirrors /v1/embed's per-response
            # "pretrained" flag.
            "embedding_pretrained": det.is_embedding_pretrained,
            "segmentation_ready": det.is_segmentation_ready,
            "replica_devices": ([str(d) for d in self._devices]
                                if self._devices else None),
            "replica_stats": (
                {str(mode): pool.stats
                 for mode, pool in list(self._pools.items())}
                if self._devices else None),
        }

    # -- plumbing --------------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet by default
                pass

            def _reply(self, status: int, payload, endpoint: str,
                       t0: float, content_type="application/json",
                       extra_headers=None):
                body = (payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode())
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass
                server._m_requests.labels(endpoint, str(status)).inc()
                server._m_latency.labels(endpoint).observe(
                    (time.monotonic() - t0) * 1000.0)

            def do_GET(self):
                t0 = time.monotonic()
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._reply(200, {"status": "ok",
                                      "ready": server._det.is_ready},
                                "healthz", t0)
                elif path == "/metrics":
                    self._reply(200, server.registry.render().encode(),
                                "metrics", t0,
                                content_type="text/plain; version=0.0.4")
                elif path == "/v1/info":
                    status, payload = server._do_info()
                    self._reply(status, payload, "info", t0)
                else:
                    self._reply(404, {"error": f"no such path {path}"},
                                "unknown", t0)

            def do_POST(self):
                t0 = time.monotonic()
                parsed = urlparse(self.path)
                path = parsed.path
                q = parse_qs(parsed.query)
                routes = {
                    "/v1/detect": server._do_detect,
                    "/v1/segment": server._do_segment,
                    "/v1/embed": server._do_embed,
                    "/v1/detect_with_segmentation":
                        server._do_detect_with_segmentation,
                }
                endpoint = path.rsplit("/", 1)[-1] or "unknown"
                handler_fn = routes.get(path)
                if handler_fn is None:
                    self._reply(404, {"error": f"no such path {path}"},
                                "unknown", t0)
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    self._reply(411, {"error": "bad Content-Length"},
                                endpoint, t0)
                    return
                if length <= 0:
                    self._reply(400, {"error": "empty body; POST raw "
                                               "image bytes"}, endpoint, t0)
                    return
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": f"body exceeds "
                                               f"{MAX_BODY_BYTES} bytes"},
                                endpoint, t0)
                    return
                body = self.rfile.read(length)
                server._m_inflight.inc()
                extra = None
                try:
                    status, payload = handler_fn(body, q)
                except ServerOverloaded as e:  # bounded queue full: shed
                    server._m_shed.inc()
                    status, payload = 503, {"error": str(e)}
                    extra = {"Retry-After": "1"}
                except ValueError as e:       # decode / validation errors
                    status, payload = 400, {"error": str(e)}
                except Exception as e:        # noqa: BLE001 — 500 boundary
                    status, payload = 500, {"error": f"{type(e).__name__}: "
                                                     f"{e}"}
                finally:
                    server._m_inflight.dec()
                self._reply(status, payload, endpoint, t0,
                            extra_headers=extra)

        return Handler
