"""Host-side image IO: encoded bytes and files to RGB arrays.

Port of the decode half of the JAX package's ``utils/image.py``: one
decode on the host, RGB from the start, in the JAX order: the native
JPEG/PNG/WebP pool (``utils/native.py``), then PIL, then cv2.  Everything
after the decode runs on the device.
"""

from __future__ import annotations

import io
import threading

import numpy as np

__all__ = ["decode_image", "decode_images", "load_image",
           "validate_batch_shape"]


def validate_batch_shape(shape) -> None:
    """Raises ValueError unless ``shape`` is a [B, H, W, {1, 3, 4}] or a
    [B, H, W] (grayscale) batch; from the shape alone, so a malformed batch
    fails before it is uploaded."""
    if len(shape) == 3:
        if shape[-1] in (1, 3, 4):
            raise ValueError(
                f"ambiguous 3-D input {tuple(shape)}: looks like a single "
                "[H, W, C] image — add a batch axis (img[None]); a "
                "grayscale batch must be passed as [B, H, W, 1]")
        return
    if len(shape) != 4:
        raise ValueError(
            f"expected [B, H, W, C] image batch, got shape {tuple(shape)}")
    if shape[-1] not in (1, 3, 4):
        raise ValueError(
            f"unsupported channel count {shape[-1]} (want 1, 3 or 4)")


_pool = None
_pool_lock = threading.Lock()


def _native_pool():
    """The shared native decode pool, or None where it is unavailable."""
    global _pool
    with _pool_lock:
        if _pool is None:
            try:
                from .native import ImageDecoderPool
                _pool = ImageDecoderPool()
            except RuntimeError:
                _pool = False
        return _pool or None


def _native_format(data: bytes) -> bool:
    """True when the bytes carry a container the native pool decodes (the
    magic numbers ``runtime/decode.cc`` routes on)."""
    return (data[:2] == b"\xff\xd8"
            or data[:8] == b"\x89PNG\r\n\x1a\n"
            or (data[:4] == b"RIFF" and data[8:12] == b"WEBP"))


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> RGB uint8 [H, W, 3].  JPEG, PNG and WebP go
    through the native pool where it is available; anything else, or what
    the native layer refuses (a 16-bit PNG, an animated WebP), through PIL,
    then cv2.  Raises ValueError on bytes none of them decodes."""
    pool = _native_pool()
    if pool is not None and _native_format(data):
        try:
            return pool.decode(data)
        except ValueError:
            pass
    pil_error = None
    try:
        from PIL import Image
        try:
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception as e:
            pil_error = e
    except ImportError:
        pass
    try:
        import cv2
        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if arr is not None:
            return arr[..., ::-1].copy()
    except ImportError:
        if pil_error is None:
            raise RuntimeError(
                "no image decoder: the native pool, PIL and cv2 are all "
                "unavailable") from None
    raise ValueError("Failed to decode image bytes"
                     + (f": {pil_error}" if pil_error else ""))


def decode_images(datas: list[bytes]) -> list[np.ndarray]:
    """Decodes a batch; JPEG/PNG/WebP batches (formats may be mixed) go
    through the threaded native pool."""
    pool = _native_pool()
    if pool is not None and all(_native_format(d) for d in datas):
        try:
            return pool.decode_batch(datas)
        except ValueError:
            pass
    return [decode_image(d) for d in datas]


def load_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read())
