"""Replica serving: independent batches on independent devices.

Port of the JAX package's ``parallel/replica.py``.  There are two ways to
spread the work over several devices:

* ``parallel/sharding.py`` (``FaceDetector(data_parallel=True)``) splits ONE
  batch over the mesh: lower latency a batch, one batch in flight.
* This module gives each device its own copy of the detector's weights and
  its own pinned :class:`~..pipeline.serving.ServingPipeline`: N
  independent batches in flight, for independent request streams.  It is
  the production serving shape, the counterpart of the reference's
  interpreter pool (`face_detector_core.dart:151-166`).

The weights are a few MB (``FaceDetector.memory_report``), so a copy a
device costs little, and the devices never communicate.  A device may
repeat: two replicas on one card overlap one replica's host work with the
other's device work.

    pool = ReplicaPool(detector)                # every visible card
    futures = [pool.submit(batch) for batch in stream]   # round-robin
    results = [f.result() for f in futures]     # in submit order
    pool.close()
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from ..pipeline.config import FaceDetectionMode
from ..pipeline.serving import ServingPipeline
from ..utils.image import decode_images
from . import sharding

__all__ = ["ReplicaPool"]


class ReplicaPool:
    """Round-robin pool of device-pinned serving pipelines.

    Each device gets a replica of ``detector``'s weights
    (``FaceDetector._replica_params``) and its own pipelined executor;
    ``submit`` hands batches out round-robin.  Futures resolve
    independently (a slow device delays only its own batches); consuming
    them in submit order gives the results in order, as with
    ``ServingPipeline``.  ``devices`` defaults to every visible device of
    the detector's kind (``parallel.sharding.visible_devices``).
    """

    def __init__(self, detector,
                 devices: Optional[Sequence] = None,
                 mode: FaceDetectionMode = FaceDetectionMode.STANDARD,
                 depth: int = 2):
        if getattr(detector, "_mesh", None) is not None:
            raise ValueError(
                "ReplicaPool replicates per chip; it cannot wrap a "
                "data_parallel detector (which shards each batch across "
                "the mesh instead — pick one shape)")
        devices = list(devices if devices is not None else
                       sharding.visible_devices(detector.device.type))
        if not devices:
            raise ValueError("no devices to replicate onto")
        self._devices = devices
        # Every replica's weights before the first batch, so that no
        # batch pays for a copy.
        for d in devices:
            detector._replica_params(d)
        self._pipes = [ServingPipeline(detector, mode, depth=depth,
                                       device=d) for d in devices]
        self._next = 0
        self._lock = threading.Lock()
        self._closed = False
        #: Per-replica counters, index-aligned with the devices: accepted =
        #: batches queued on it; skipped = submits that passed it over
        #: because its queue was full.
        self._accepted = [0] * len(devices)
        self._skipped = [0] * len(devices)

    @property
    def num_replicas(self) -> int:
        return len(self._devices)

    @property
    def stats(self) -> list:
        """Per-replica load counters, ``[{"device", "accepted",
        "skipped_full"}, ...]``: a replica whose ``skipped_full`` climbs
        while ``accepted`` stalls is slow or stuck (its queue stays
        full)."""
        with self._lock:
            return [{"device": str(d), "accepted": a, "skipped_full": s}
                    for d, a, s in zip(self._devices, self._accepted,
                                       self._skipped)]

    def submit(self, images, orig_sizes=None) -> Future:
        """Queues one batch on the next replica (round-robin); returns a
        Future of list[list[Face]].  Takes what ``ServingPipeline.submit``
        takes (a list of encoded bytes, a numpy batch or a tensor, and
        ``orig_sizes`` for a batch padded into one size bucket).

        A replica whose bounded queue is full is passed over for the next
        one, so a slow replica delays only the batches already queued on
        it; a submit blocks only when every replica's queue is full (the
        pool-wide memory bound).  Encoded bytes are decoded once, here."""
        if isinstance(images, (list, tuple)) and images and \
                isinstance(images[0], (bytes, bytearray)):
            # Decoded once on the caller's thread: a fail-over must not
            # decode again for each replica it tries.
            images = np.stack(decode_images(list(images)))
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplicaPool is closed")
            start = self._next
            self._next = (self._next + 1) % len(self._pipes)
        for i in range(len(self._pipes)):
            k = (start + i) % len(self._pipes)
            fut = self._pipes[k].try_submit(images, orig_sizes=orig_sizes)
            if fut is not None:
                with self._lock:
                    self._accepted[k] += 1
                return fut
            with self._lock:
                self._skipped[k] += 1
        fut = self._pipes[start].submit(images, orig_sizes=orig_sizes)
        with self._lock:
            self._accepted[start] += 1
        return fut

    def map_batches(self, batches) -> list:
        """Submits every batch and returns their results in order."""
        futs = [self.submit(b) for b in batches]
        return [f.result() for f in futs]

    def close(self, wait: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for p in self._pipes:
            p.close(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
