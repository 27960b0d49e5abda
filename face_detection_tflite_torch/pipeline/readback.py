"""One packed readback: a device program's named outputs in one byte
buffer, one device-to-host copy, and their arrays on the host.

The JAX detector runs a packer program after each pipeline program and
reads one buffer back.  Here the pack is part of the program itself
(:func:`packed_readback`, or :func:`pack_readback` inside it), so that on
a card it is part of the program key's CUDA graph (``pipeline/graphs.py``)
and a replay clones one buffer, not every output.  Every owner of device
programs reads back through this module: the detector's pipeline
programs, the segmenter's mask program (``models/segmentation.py``) and
the standalone model classes (``models/standalone.py``).

A packed buffer is ``[B, bytes]`` uint8, one row a batch row, and a
:class:`ReadbackLayout` says where each named output lies in a row and
how it is encoded: float32 and int32 bitcast (``"f32"``, ``"i32"``),
uint8 codes as they are (``"u8"``), bool as a byte (``"bool"``), and the
mesh and iris landmarks as int16 at the readback's quant scale
(``"i16"``).  A program that stamps the card's clock
(``pipeline/timings.py``, "Stage stamps") packs its stamps in every row
(:data:`STAMPS`), 8 bytes a stamp a row; the unpack takes them out of the
arrays and adds them to the timings of the span the caller has open
(``timings.record_stamps``).

The host side has three steps, each without a span of its own:
:func:`start` (the copy to pinned memory), :func:`wait` (for the copy)
and :func:`unpack` (the arrays).  The detector times them in its spans
``pack``, ``compute_wait`` and ``readback`` (:func:`fetch_async`,
:func:`fetch_finish`); the segmenter in ``segment.dispatch``,
``segment.wait`` and ``segment.materialize``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import timings
from .timings import span, stage_range
from .upload import download_async

__all__ = ["ReadbackLayout", "pack_readback", "packed_readback", "STAMPS",
           "start", "wait", "unpack", "fetch_async", "fetch_finish",
           "fetch"]

#: Outputs read back as int16 at the readback's quant scale.
_QUANT_KEYS = frozenset({"mesh", "iris"})
#: Sections in this order (4-byte, then 2-byte, then 1-byte), so that every
#: section's offset in a packed row stays aligned for the host's views.
_RANK = {"f32": 0, "i32": 1, "i16": 2, "bool": 3, "u8": 3}
#: The readback entry of a program's stage stamps (``pipeline/timings.py``):
#: its int64 stamps as int32 pairs, the same in every row.
STAMPS = "stamps"


def _readback_encoding(name: str, dtype, quant_scale) -> str:
    if dtype == torch.bool:
        return "bool"
    if dtype == torch.uint8:
        return "u8"
    if not dtype.is_floating_point:
        return "i32"
    if quant_scale and name in _QUANT_KEYS:
        return "i16"
    return "f32"


class ReadbackLayout:
    """Where each output lies in a packed readback row: ``entries`` of
    (name, shape of a row, encoding) in byte order, the px -> int16
    scale of the quantized landmarks, and the names of the program's stage
    stamps in the :data:`STAMPS` entry (empty where it has none).  The
    host-side half of the JAX detector's readback packer."""

    __slots__ = ("entries", "quant_scale", "stamps")

    def __init__(self, entries: tuple, quant_scale: Optional[float],
                 stamps: tuple = ()):
        self.entries = entries
        self.quant_scale = quant_scale
        self.stamps = stamps

    def unpack(self, host: np.ndarray) -> dict:
        """The arrays of a packed ``[rows, bytes]`` host buffer."""
        result = {}
        off = 0
        for k, row_shape, enc in self.entries:
            n = int(np.prod(row_shape))
            shape = (host.shape[0],) + row_shape
            if enc in ("bool", "u8"):
                codes = host[:, off:off + n]
                result[k] = (codes > 0 if enc == "bool" else codes
                             ).reshape(shape)
                off += n
            elif enc == "i16":
                result[k] = (host[:, off:off + 2 * n].view(np.int16)
                             .astype(np.float32) / self.quant_scale
                             ).reshape(shape)
                off += 2 * n
            elif enc == "i32":
                result[k] = host[:, off:off + 4 * n].view(
                    np.int32).reshape(shape)
                off += 4 * n
            else:
                result[k] = host[:, off:off + 4 * n].view(
                    np.float32).reshape(shape)
                off += 4 * n
        return result


def pack_readback(out: dict, quant_scale: Optional[float] = None
                  ) -> tuple[torch.Tensor, ReadbackLayout]:
    """Packs a program's ``[B, ...]`` outputs into one ``[B, bytes]`` uint8
    buffer on their device, for one device-to-host copy (module
    docstring; the JAX detector's readback packer,
    ``pipeline/detector.py::_fetch_async``).  Rows are packed
    independently, so a prefix of the buffer's rows is the packing of the
    outputs' same rows.  One output alone is packed as a view of its
    bytes, with no copy."""
    entries = sorted(((_readback_encoding(k, v.dtype, quant_scale), k, v)
                      for k, v in out.items()),
                     key=lambda e: (_RANK[e[0]], e[1]))
    segs = []
    for enc, _, x in entries:
        x = x.reshape(x.shape[0], -1)
        if enc in ("bool", "u8"):
            segs.append(x.to(torch.uint8))
            continue
        if enc == "i16":
            x = torch.clamp(torch.round(x * quant_scale), -32767.0,
                            32767.0).to(torch.int16)
        elif enc == "i32":
            x = x.to(torch.int32)
        else:
            x = x.float()
        segs.append(x.contiguous().view(torch.uint8))
    layout = ReadbackLayout(tuple((k, tuple(v.shape[1:]), e)
                                  for e, k, v in entries), quant_scale)
    return (segs[0] if len(segs) == 1 else torch.cat(segs, dim=1)), layout


def packed_readback(fn, quant_scale: Optional[float]):
    """``fn`` (a program of named ``[B, ...]`` outputs) with its readback
    packed inside it: ``{"packed": [B, bytes] uint8, "layout":
    ReadbackLayout}`` beside the ``det_*`` slab a speculative detector
    program keeps on the device for the overflow re-run (its
    ``det_count`` goes into the packed buffer).  On a card the program
    also stamps the start of each stage group and its end
    (``timings.stamping``), and the stamps go into the packed buffer
    (:data:`STAMPS`), so that each call carries its own; a program that
    enters no stage group (a standalone model class's) stamps nothing."""
    def run(*args):
        with timings.stamping(args[0].device) as stamps:
            out = fn(*args)
            if stamps is not None and stamps.names:
                stamps.stamp("pack")
            else:
                stamps = None
        kept = {k: v for k, v in out.items()
                if k.startswith("det_") and k != "det_count"}
        packed = {k: v for k, v in out.items() if k not in kept}
        with stage_range("fdt.pack"):
            if stamps is not None:
                rows = next(iter(packed.values())).shape[0]
                packed[STAMPS] = stamps.values().view(torch.int32)[
                    None].expand(rows, -1)
            buf, layout = pack_readback(packed, quant_scale)
        if stamps is not None:
            layout.stamps = tuple(stamps.names)
        return {"packed": buf, "layout": layout, **kept}
    return run


def start(out, rows: Optional[int] = None):
    """Starts the copy of a program's packed readback (its first ``rows``
    rows: a batch's pad rows stay on the device) to pinned host memory,
    and returns the handle :func:`wait` and :func:`unpack` take.  A list
    of shard outputs (``data_parallel``) is fetched shard by shard, each
    from its own device, into a list of handles; a shard left with no
    row is not fetched."""
    if not isinstance(out, list):
        return (*download_async(out["packed"][:rows]), out["layout"])
    n = out[0]["packed"].shape[0]
    rows = len(out) * n if rows is None else rows
    return [(*download_async(o["packed"][:min(rows - i * n, n)]),
             o["layout"]) for i, o in enumerate(out) if rows > i * n]


def wait(handle) -> None:
    """Waits for the device-to-host copies of a handle (or a list)."""
    for h in handle if isinstance(handle, list) else (handle,):
        if h[1] is not None:
            h[1].synchronize()


def unpack(handle) -> dict:
    """The arrays of one waited handle (:func:`wait`); its stage stamps go
    to the enclosing span's owner as ``device.<group>`` ms
    (``timings.record_stamps``), not into the arrays."""
    host, _, layout = handle
    out = layout.unpack(host.numpy())
    stamps = out.pop(STAMPS, None)
    if stamps is not None and len(stamps):
        timings.record_stamps(layout.stamps, stamps[0].view(np.int64))
    return out


def fetch_async(out, rows: Optional[int] = None):
    """:func:`start` in the span ``pack``; :func:`fetch_finish` waits and
    unpacks."""
    with span("pack"):
        return start(out, rows)


def fetch_finish(handle) -> dict:
    """Waits for a fetch (span ``compute_wait``) and unpacks it (span
    ``readback``), shard by shard; the shards' arrays are joined."""
    if isinstance(handle, list):
        parts = [fetch_finish(h) for h in handle]
        return parts[0] if len(parts) == 1 else {
            k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    with span("compute_wait"):
        wait(handle)
    with span("readback"):
        return unpack(handle)


def fetch(out, rows: Optional[int] = None) -> dict:
    """The arrays of a program's packed readback, waited for."""
    return fetch_finish(fetch_async(out, rows))
