"""Host-side image IO: encoded bytes, files and camera planes to RGB.

Port of the JAX package's ``utils/image.py``: one decode on the host, RGB
from the start, in the JAX order: the native JPEG/PNG/WebP pool
(``utils/native.py``), then PIL, then cv2; the ``maxDim`` downscale and
the YUV420 conversion of the camera paths on the host; and
:func:`normalize_channels`, the channel tolerance every public entry point
shares, on tensors.  Everything after it runs on the device.
"""

from __future__ import annotations

import io
import threading

import numpy as np
import torch

from ..pipeline.upload import upload

__all__ = ["decode_image", "decode_images", "load_image", "rgb_from_yuv420",
           "normalize_channels", "validate_batch_shape", "fit_max_dim"]


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


def fit_max_dim(image: np.ndarray, max_dim: int) -> np.ndarray:
    """Downscales so the longer side fits ``max_dim`` (cv2 INTER_LINEAR);
    returns the input unchanged when it already fits.  The reference's
    ``maxDim`` knob (`helpers.dart:488-493`), shared by the camera, video
    and standalone detection paths."""
    h, w = image.shape[:2]
    if max(h, w) <= max_dim:
        return image
    import cv2
    scale = max_dim / max(h, w)
    return cv2.resize(np.ascontiguousarray(image),
                      (int(w * scale), int(h * scale)),
                      interpolation=cv2.INTER_LINEAR)


def normalize_channels(images, device: torch.device) -> torch.Tensor:
    """A [B, H, W, {1, 3, 4}] or [B, H, W] (grayscale) batch, numpy or
    tensor -> [B, H, W, 3] on ``device`` (BGRA drops alpha, grayscale
    replicates; `helpers.dart:377-398`).  The shape is validated
    (:func:`validate_batch_shape`) before the upload
    (``pipeline/upload.py``), which keeps uint8 and casts anything else to
    float32."""
    validate_batch_shape(images.shape)
    if images.ndim == 3:
        images = images[..., None]
    t = upload(images, device)
    c = t.shape[-1]
    if c == 4:
        t = t[..., :3]
    elif c == 1:
        t = t.expand(*t.shape[:-1], 3)
    return t.contiguous()


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


def rgb_from_yuv420(y: np.ndarray, u: np.ndarray, v: np.ndarray
                    ) -> np.ndarray:
    """Planar YUV420 (BT.601 video range) -> RGB uint8, in numpy on the
    host: the camera-stream analog of the reference's `cameraFrameToBgrMat`
    YUV plans (`helpers.dart:479-560`, I420 path)."""
    h, w = y.shape

    def upsample2(c):
        full = np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)
        # Odd sizes: the ceil-half chroma falls one row or column short of
        # the frame after the 2x repeat; extend it with the edge sample.
        pad_h, pad_w = max(0, h - full.shape[0]), max(0, w - full.shape[1])
        if pad_h or pad_w:
            full = np.pad(full, ((0, pad_h), (0, pad_w)), mode="edge")
        return full[:h, :w]

    u_full = upsample2(u)
    v_full = upsample2(v)
    yf = y.astype(np.float32) - 16.0
    uf = u_full.astype(np.float32) - 128.0
    vf = v_full.astype(np.float32) - 128.0
    r = 1.164 * yf + 1.596 * vf
    g = 1.164 * yf - 0.392 * uf - 0.813 * vf
    b = 1.164 * yf + 2.017 * uf
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
