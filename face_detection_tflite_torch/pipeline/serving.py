"""Throughput serving executor: decode and upload overlap device work.

Port of the JAX package's ``pipeline/serving.py``.  The caller's thread
decodes a batch (the native JPEG/PNG/WebP pool) and uploads it through the
pinned ring (``pipeline/upload.py``, asynchronous on the upload stream); a
worker thread queues the batch's program and readback, and while more
batches wait it queues the next batch's program before this batch's
readback blocks.  Steady-state throughput is then about the largest of
decode, upload and compute instead of their sum.

    pipe = ServingPipeline(detector, mode=FaceDetectionMode.STANDARD)
    futures = [pipe.submit(jpeg_bytes_batch) for batch in stream]
    faces = futures[0].result()     # list[list[Face]]
    pipe.close()
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from .config import FaceDetectionMode
from .upload import upload
from ..utils.image import decode_images, validate_batch_shape

__all__ = ["ServingPipeline"]


class ServingPipeline:
    """Two-stage pipelined executor over a FaceDetector.

    Stage 1 (the submitting thread): decode, host batch assembly and the
    upload.  Stage 2 (one worker thread): the program, the readback and
    the Face objects.  ``depth`` bounds both queues: at most ``depth``
    submitted batches wait (submission blocks beyond that) and at most
    ``depth`` + 1 are in flight on the device, so at most 2·depth + 1
    batches are alive.  A Future cancelled while its batch is queued is
    skipped; once dispatched it can no longer be cancelled.

    The worker runs each batch on the stream that was current on the
    submitting thread, the stream its upload is ordered on, and in
    inference mode (both are per-thread state in PyTorch).
    """

    def __init__(self, detector, mode: FaceDetectionMode =
                 FaceDetectionMode.STANDARD, depth: int = 2,
                 with_segmentation: bool = False, device=None):
        if device is not None and not _same_device(torch.device(device),
                                                   detector.device):
            raise NotImplementedError(
                f"device pinning to {device} (the detector runs on "
                f"{detector.device}) is not ported yet (ROADMAP §1 item 7)")
        if depth < 1:
            # queue.Queue(maxsize=0) would be unbounded and void the
            # 2·depth + 1 bound.
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._det = detector
        self._mode = mode
        self._depth = depth
        #: Each Future resolves to list[(faces, mask)]: the mask program
        #: is queued before the detection of the same batch, and both
        #: readbacks are waited on in the worker's finish step.
        self._with_segmentation = with_segmentation
        if with_segmentation:
            detector._segmenter()  # the detector's configured model
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._closed = False
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="fdt-serving")
        self._worker.start()

    def submit(self, images, orig_sizes=None) -> Future:
        """Enqueues a batch; returns a Future of list[list[Face]], or of
        list[(faces, SegmentationMask)] with ``with_segmentation``.

        ``images`` may be encoded image bytes (list[bytes]), a numpy
        [B, H, W, C] batch or a tensor.  The decode and the upload run on
        the calling thread, so they overlap earlier batches' device work.
        ``orig_sizes`` (per-image (w, h)) marks a batch whose images were
        padded into one shared size bucket."""
        return self._submit_impl(images, True, orig_sizes)

    def try_submit(self, images, orig_sizes=None) -> Optional[Future]:
        """Like :meth:`submit`, but None instead of blocking when the
        bounded queue is full."""
        return self._submit_impl(images, False, orig_sizes)

    def _submit_impl(self, images, block: bool,
                     orig_sizes=None) -> Optional[Future]:
        if isinstance(images, (list, tuple)) and images and \
                isinstance(images[0], (bytes, bytearray)):
            images = np.stack(decode_images(list(images)))
        elif not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        # Shape first, so a malformed batch raises here and not in the
        # worker's stream.
        validate_batch_shape(images.shape)
        images = upload(images, self._det.device)
        stream = (torch.cuda.current_stream(images.device)
                  if images.device.type == "cuda" else None)
        fut: Future = Future()
        # The executor's stream identity, for completion-time consumers
        # (the server's adaptive cap).
        fut.fdt_stream = id(self)
        # Atomic with close(): a batch never lands behind the sentinel.
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("ServingPipeline is closed")
            item = (images, orig_sizes, stream, fut)
            if block:
                self._q.put(item)
            else:
                try:
                    self._q.put_nowait(item)
                except queue.Full:
                    return None
        return fut

    def _run(self):
        with torch.inference_mode():
            self._loop()

    def _loop(self):
        # Under load the next batch's program is queued before this
        # batch's readback blocks; with the queue empty, pending work
        # finishes at once.  Futures resolve in submit order.
        pending: collections.deque = collections.deque()

        def finish_one():
            fut, handle, stream, seg_handle = pending.popleft()
            try:
                with _on_stream(stream):
                    result = self._det._stream_finish(handle, self._mode)
                    if seg_handle is not None:
                        result = list(zip(result,
                                          self._det._segmentation.materialize(
                                              seg_handle)))
            except Exception as e:
                fut.set_exception(e)
                return
            fut.set_result(result)

        while True:
            try:
                item = self._q.get(block=not pending)
            except queue.Empty:
                finish_one()
                continue
            if item is None:
                break
            images, orig_sizes, stream, fut = item
            # QUEUED -> RUNNING; a Future cancelled while queued is
            # skipped, and a running one can no longer be cancelled.
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                with _on_stream(stream):
                    seg_handle = (
                        self._det._segmentation.dispatch(images)
                        if self._with_segmentation and images.shape[0]
                        else None)
                    pending.append((fut, self._det._stream_dispatch(
                        images, self._mode, orig_sizes), stream, seg_handle))
            except Exception as e:
                fut.set_exception(e)
            if len(pending) > self._depth:
                finish_one()
        while pending:
            finish_one()

    def close(self, wait: bool = True) -> None:
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        if wait:
            self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _same_device(d: torch.device, own: torch.device) -> bool:
    """Whether ``d`` names ``own`` (``cuda`` names the current card)."""
    return d.type == own.type and d.index in (None, own.index)


def _on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing for a CPU batch."""
    return torch.cuda.stream(stream) if stream is not None else \
        contextlib.nullcontext()
