"""Camera-frame decoding: packed YUV/RGBA planes -> RGB arrays.

A copy of the JAX package's ``utils/camera.py``, which is numpy on the
host in both packages.  Analog of the reference's `CameraFrame` decode
plans (`helpers.dart:479-560`, flutter_litert's backend-neutral plan
mapped onto OpenCV): NV12/NV21/I420 colour conversion (BT.601 video
range), BGRA/RGBA alpha drop, stride-padding crop, and 90-degree
rotations.  The resulting RGB array feeds ``FaceDetector.detect_faces``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from .image import rgb_from_yuv420

__all__ = ["CameraFormat", "CameraRotation", "CameraFrame",
           "camera_frame_from_image", "camera_frame_from_planes",
           "decode_camera_frame"]


class CameraFormat(enum.Enum):
    NV12 = "nv12"    # Y plane + interleaved UV
    NV21 = "nv21"    # Y plane + interleaved VU
    I420 = "i420"    # planar Y, U, V
    BGRA = "bgra"
    RGBA = "rgba"


class CameraRotation(enum.IntEnum):
    """Clockwise rotation to apply after decode (cw90/cw180/cw270)."""

    NONE = 0
    CW90 = 90
    CW180 = 180
    CW270 = 270


@dataclasses.dataclass
class CameraFrame:
    """One packed camera frame, as delivered by a camera HAL."""

    data: bytes
    width: int
    height: int
    format: CameraFormat
    rotation: CameraRotation = CameraRotation.NONE
    row_stride: Optional[int] = None  # Y/RGBA plane stride, if padded
    #: Chroma-plane row stride in bytes.  Defaults: interleaved NV12/NV21 UV
    #: rows inherit the Y stride; planar I420 U/V rows use half of it
    #: (standard HAL layouts).
    chroma_row_stride: Optional[int] = None


def _strip_stride(plane: np.ndarray, width: int, stride: Optional[int],
                  bpp: int = 1) -> np.ndarray:
    if stride is None or stride == width * bpp:
        return plane.reshape(-1, width * bpp)
    return plane.reshape(-1, stride)[:, :width * bpp]


def decode_camera_frame(frame: CameraFrame,
                        max_dim: Optional[int] = None) -> np.ndarray:
    """CameraFrame -> RGB uint8 [H, W, 3] (rotation applied).

    ``max_dim`` downscales so the longer side fits (INTER_LINEAR, applied
    before rotation) — the reference's ``maxDim`` knob for live-camera
    throughput (`helpers.dart:488-493`).  Results are then in the
    downscaled frame's coordinate system, exactly as the reference's.
    """
    w, h = frame.width, frame.height
    raw = np.frombuffer(frame.data, np.uint8)

    if frame.format in (CameraFormat.BGRA, CameraFormat.RGBA):
        stride = frame.row_stride or w * 4
        px = _strip_stride(raw[:stride * h], w, stride, 4).reshape(h, w, 4)
        rgb = px[..., [2, 1, 0]] if frame.format == CameraFormat.BGRA \
            else px[..., :3]
    else:
        y_stride = frame.row_stride or w
        y_size = y_stride * h
        y = _strip_stride(raw[:y_size], w, y_stride).reshape(h, w)
        chroma = raw[y_size:]
        cw, ch = (w + 1) // 2, (h + 1) // 2
        if frame.format == CameraFormat.I420:
            # Ceil-half: for odd widths the chroma plane is (w+1)//2 wide,
            # so a floored y_stride//2 default would undershoot the plane
            # and break the reshape on a perfectly valid frame.
            c_stride = frame.chroma_row_stride or \
                ((y_stride + 1) // 2 if frame.row_stride else cw)
            plane = c_stride * ch
            u = _strip_stride(chroma[:plane], cw, c_stride).reshape(ch, cw)
            v = _strip_stride(chroma[plane:2 * plane], cw,
                              c_stride).reshape(ch, cw)
        else:
            # Interleaved UV rows are 2*ceil(w/2) bytes; for ODD widths
            # that exceeds an unpadded y_stride (the same ceil-half bug
            # the I420 branch guards above), so floor the default at
            # 2*cw.
            c_stride = frame.chroma_row_stride or \
                (max(y_stride, 2 * cw) if frame.row_stride else 2 * cw)
            plane = c_stride * ch
            inter = _strip_stride(chroma[:plane], 2 * cw,
                                  c_stride).reshape(ch, cw, 2)
            if frame.format == CameraFormat.NV12:
                u, v = inter[..., 0], inter[..., 1]
            else:  # NV21
                v, u = inter[..., 0], inter[..., 1]
        rgb = rgb_from_yuv420(y, u, v)

    if max_dim is not None:
        from .image import fit_max_dim
        rgb = fit_max_dim(rgb, max_dim)

    k = {CameraRotation.NONE: 0, CameraRotation.CW90: 3,
         CameraRotation.CW180: 2, CameraRotation.CW270: 1}[frame.rotation]
    if k:
        rgb = np.rot90(rgb, k)
    return np.ascontiguousarray(rgb)


def camera_frame_from_image(image: np.ndarray,
                            rotation: CameraRotation = CameraRotation.NONE
                            ) -> CameraFrame:
    """Packs an RGB/RGBA image into a CameraFrame (RGBA layout).

    Analog of flutter_litert's `prepareCameraFrameFromImage`
    (re-exported at face_native_lib.dart:81) — mainly for tests and for
    feeding still images through camera-frame code paths.
    """
    img = np.asarray(image, np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] image, got {img.shape}")
    if img.shape[2] == 3:
        img = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
    h, w, _ = img.shape
    return CameraFrame(data=img.tobytes(), width=w, height=h,
                       format=CameraFormat.RGBA, rotation=rotation)


def _plane_field(plane, *names, default=None):
    for n in names:
        if isinstance(plane, dict):
            if n in plane:
                return plane[n]
        elif hasattr(plane, n):
            return getattr(plane, n)
    return default


def _plane_rows(plane, width_bytes: int, rows: int,
                default_stride: Optional[int] = None
                ) -> Optional[np.ndarray]:
    """[rows, width_bytes] view of a camera plane, honoring row stride.

    ``default_stride`` is the row pitch assumed when the plane omits
    ``bytes_per_row`` — it can exceed ``width_bytes`` (a pixel-stride-2
    chroma row spans the full interleaved width but only its first
    ``2*(cw-1)+1`` bytes are meaningful).  The last row of a strided plane
    is commonly delivered short (HALs pad rows, not the buffer tail), so
    it is sliced leniently.
    """
    data = _plane_field(plane, "bytes", "data")
    if data is None:
        return None
    raw = np.frombuffer(bytes(data), np.uint8)
    stride = int(_plane_field(plane, "bytes_per_row", "bytesPerRow",
                              default=default_stride or width_bytes)
                 # A present-but-falsy field (bytesPerRow: null/0) must
                 # fall back to default_stride too, not width_bytes — for
                 # pixel-stride-2 chroma those differ by one byte and the
                 # de-interleave silently shifts every row.
                 or (default_stride or width_bytes))
    if stride < width_bytes or raw.size < stride * (rows - 1) + width_bytes:
        return None
    if raw.size >= stride * rows:
        return raw[:stride * rows].reshape(rows, stride)[:, :width_bytes]
    # Short-tail buffer (HAL padded rows, unpadded final row).
    out = np.empty((rows, width_bytes), np.uint8)
    for r in range(rows):
        out[r] = raw[r * stride:r * stride + width_bytes]
    return out


def camera_frame_from_planes(width: int, height: int, planes,
                             rotation: CameraRotation = CameraRotation.NONE,
                             is_bgra: bool = False
                             ) -> Optional[CameraFrame]:
    """Builds a CameraFrame from CameraImage-shaped planes (duck-typed).

    Analog of flutter_litert's `prepareCameraFrameFromImage`
    (`face_detector.dart:651-666`): each plane is any object or mapping
    exposing ``bytes`` plus optional ``bytes_per_row``/``bytesPerRow`` and
    ``bytes_per_pixel``/``bytesPerPixel``.  Layouts handled:

    * 1 plane, 4 bytes/pixel — desktop BGRA (``is_bgra=True``) or RGBA;
    * 2 planes — Y + interleaved UV (NV12, the iOS/AVFoundation shape);
    * 3 planes, chroma pixel stride 1 — planar I420;
    * 3 planes, chroma pixel stride 2 — Android's interleaved U/V views,
      de-interleaved here to planar I420.

    Returns None when the plane shape can't be decoded (the reference's
    contract: callers turn that into an empty face list, not an error).
    """
    try:
        w, h = int(width), int(height)
        planes = list(planes)
    except (TypeError, ValueError):
        return None
    if w <= 0 or h <= 0 or not planes:
        return None
    cw, ch = (w + 1) // 2, (h + 1) // 2

    if len(planes) == 1:
        px = _plane_rows(planes[0], w * 4, h)
        if px is None:
            return None
        fmt = CameraFormat.BGRA if is_bgra else CameraFormat.RGBA
        return CameraFrame(data=px.tobytes(), width=w, height=h,
                           format=fmt, rotation=rotation)

    y = _plane_rows(planes[0], w, h)
    if y is None:
        return None

    if len(planes) == 2:
        uv = _plane_rows(planes[1], 2 * cw, ch)
        if uv is None:
            return None
        return CameraFrame(data=y.tobytes() + uv.tobytes(), width=w,
                           height=h, format=CameraFormat.NV12,
                           rotation=rotation)

    if len(planes) == 3:
        bpp = int(_plane_field(planes[1], "bytes_per_pixel", "bytesPerPixel",
                               default=1) or 1)
        if bpp not in (1, 2):
            return None
        chroma = []
        for p in planes[1:]:
            rows = _plane_rows(p, (cw - 1) * bpp + 1, ch,
                               default_stride=cw * bpp)
            if rows is None:
                return None
            chroma.append(np.ascontiguousarray(rows[:, ::bpp]))
        u, v = chroma
        return CameraFrame(data=y.tobytes() + u.tobytes() + v.tobytes(),
                           width=w, height=h, format=CameraFormat.I420,
                           rotation=rotation)
    return None
