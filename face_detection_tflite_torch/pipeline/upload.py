"""Host-to-device frame upload through reused pinned staging buffers.

The port's counterpart of the JAX package's asynchronous
``jnp.asarray``/``device_put`` of a frame batch.  A host batch bound for the
card is copied into a pinned buffer of the calling thread's ring, then to
the card with ``non_blocking=True`` on the device's upload stream; the
caller's current stream waits on the copy's event before its next kernel.
The host returns once the copy is queued, so the copy overlaps the device
work of earlier batches.

* A ring slot is overwritten only after the event of its previous copy
  has completed, and each thread has its own ring, so a server's batcher
  thread, pipeline callers and direct ``detect_faces_batch`` callers can
  upload at once.
* The device tensor is allocated on the upload stream and marked as used
  by the caller's stream (``record_stream``), so the caching allocator does
  not hand its memory out again while a kernel of that stream reads it.
* A tensor already on the device, and the CPU device, skip the staging.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["upload", "RING_SLOTS"]

#: Pinned buffers per thread: a batch can be staged while the previous
#: batch's copy is still in flight.
RING_SLOTS = 2

_local = threading.local()
_streams: dict[int, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def _upload_stream(device: torch.device) -> "torch.cuda.Stream":
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _streams_lock:
        if index not in _streams:
            _streams[index] = torch.cuda.Stream(device=index)
        return _streams[index]


def _slot(nbytes: int) -> list:
    """The calling thread's next ring slot ``[pinned uint8 buffer, event of
    its last copy]``, holding at least ``nbytes``, once its last copy has
    completed."""
    ring = getattr(_local, "ring", None)
    if ring is None:
        ring = _local.ring = [[None, None] for _ in range(RING_SLOTS)]
        _local.next = 0
    slot = ring[_local.next]
    _local.next = (_local.next + 1) % RING_SLOTS
    if slot[1] is not None:
        slot[1].synchronize()
    if slot[0] is None or slot[0].numel() < nbytes:
        slot[0] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return slot


def _host_array(data) -> np.ndarray:
    """``data`` as a host numpy array: uint8 stays uint8, any other dtype
    is cast to float32 while it is staged."""
    if isinstance(data, torch.Tensor):
        if data.dtype not in (torch.uint8, torch.float32):
            data = data.float()
        return data.detach().cpu().numpy()
    return np.asarray(data)


def upload(data, device: torch.device) -> torch.Tensor:
    """``data`` (numpy or tensor) on ``device``, uint8 kept and any other
    dtype as float32.  To a GPU, through the calling thread's pinned ring
    and the device's upload stream, ordered before the caller's next
    kernel; a tensor already there passes through; to the CPU, without a
    copy where the dtype allows."""
    if isinstance(data, torch.Tensor) and data.device == device:
        return data if data.dtype == torch.uint8 else data.float()
    if device.type != "cuda":
        t = data if isinstance(data, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(data))
        t = t.to(device)
        return t if t.dtype == torch.uint8 else t.float()
    if isinstance(data, torch.Tensor) and data.device.type != "cpu":
        t = data.to(device)
        return t if t.dtype == torch.uint8 else t.float()
    host = _host_array(data)
    dtype = torch.uint8 if host.dtype == np.uint8 else torch.float32
    nbytes = host.size * dtype.itemsize
    slot = _slot(nbytes)
    staged = slot[0][:nbytes].view(dtype).view(host.shape)
    np.copyto(staged.numpy(), host, casting="unsafe")
    stream = _upload_stream(device)
    compute = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        dev = torch.empty(host.shape, dtype=staged.dtype, device=device)
        dev.copy_(staged, non_blocking=True)
        if slot[1] is None:
            slot[1] = torch.cuda.Event()
        slot[1].record(stream)
    compute.wait_event(slot[1])
    dev.record_stream(compute)
    return dev
