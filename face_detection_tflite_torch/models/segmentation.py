"""Selfie segmentation: binary (general and landscape) and multiclass.

Port of the JAX package's ``models/segmentation.py`` (the reference's
`lib/src/models/selfie_segmentation.dart`): the letterbox to the
segmenter's input, the segmenter network (converted from TFLite,
MediaPipe's ``Convolution2DTransposeBias`` custom op included), then
either the person plane (binary) or the per-pixel softmax over the six
classes (multiclass, `:656-699`), and for the uint8 readback
``round(clip(p, 0, 1) * 255)``, batched over images on the device.  The
planes come back through a non-blocking copy into pinned memory
(:meth:`SelfieSegmentation.dispatch`), so work queued after a dispatch is
not held up by the readback.  The mask objects and the padding-aware
``upsample`` run on the host in numpy, as in the JAX package
(`face_types.dart:282-627`).

Deliberate differences: :class:`SelfieSegmentation` runs on ``cuda``
unless the caller passes ``device="cpu"``, compiles nothing (so it keeps
no per-size program cache), and ``place_on`` (pinning to another card)
raises until the scale-out slice (ROADMAP §1 item 7).
"""

from __future__ import annotations

import enum
import math
from typing import Optional

import numpy as np
import torch

from ..convert.executor import (ConvertedModel, fp32_on_the_card,
                                resolve_device)
from ..ops.letterbox import letterbox_image, letterbox_params
from ..pipeline.upload import download_async
from ..utils.image import decode_image, normalize_channels

__all__ = ["SegmentationClass", "SegmentationMask",
           "MulticlassSegmentationMask", "SelfieSegmentation",
           "MIN_SEGMENTATION_INPUT_SIZE", "mask_valid_region",
           "corner_resize_matrix", "crop_valid_and_resize"]

MIN_SEGMENTATION_INPUT_SIZE = 16  # selfie_segmentation.dart:4


def _dart_round(x: float) -> int:
    """Dart ``.round()``: half away from zero for the non-negative values
    here (Python's ``round`` is half to even: 1500.5 -> 1500, not 1501)."""
    return int(math.floor(x + 0.5))


def mask_valid_region(width: int, height: int,
                      padding: tuple[float, float, float, float]
                      ) -> tuple[int, int, int, int]:
    """(x0, y0, x1, y1) of the non-letterbox-padding region in mask pixels
    (``maskValidRegion``, `overlay_painters.dart:41-53`)."""
    pt, pb, pl, pr = padding
    return (_dart_round(pl * width), _dart_round(pt * height),
            _dart_round((1.0 - pr) * width), _dart_round((1.0 - pb) * height))


def corner_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] bilinear weights with the reference's mask sampling:
    ``src = i * (in/out)`` with floor and a clamped neighbour
    (`face_types.dart:383-404`), corner-anchored, not cv2's half-pixel
    centres."""
    m = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    src = np.arange(out_size) * scale
    lo = np.clip(np.floor(src), 0, in_size - 1).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    for o in range(out_size):
        m[o, lo[o]] += 1.0 - frac[o]
        m[o, hi[o]] += frac[o]
    return m


def crop_valid_and_resize(data: np.ndarray, width: int, height: int,
                          padding: tuple[float, float, float, float],
                          out_w: int, out_h: int) -> np.ndarray:
    """Crops the letterbox padding off a mask-resolution plane ([H, W] or
    [H, W, C]) and resizes it bilinearly to (out_h, out_w) with
    :func:`corner_resize_matrix`."""
    x0, y0, x1, y1 = mask_valid_region(width, height, padding)
    src = data[y0:y1, x0:x1] if (x1 > x0 and y1 > y0) else data
    mh = corner_resize_matrix(src.shape[0], out_h)
    mw = corner_resize_matrix(src.shape[1], out_w)
    if src.ndim == 2:
        return mh @ src @ mw.T
    return np.einsum("Hh,hwc,Ww->HWc", mh, src, mw)


class SegmentationClass(enum.IntEnum):
    """Multiclass channel order (`face_types.dart` SegmentationClass)."""

    BACKGROUND = 0
    HAIR = 1
    BODY_SKIN = 2
    FACE_SKIN = 3
    CLOTHES = 4
    OTHER = 5


class SegmentationMask:
    """Person-probability mask in model resolution with letterbox padding.

    ``data`` is [H, W] float32 in [0, 1]; ``padding`` the normalized
    (top, bottom, left, right) letterbox padding, which :meth:`upsample`
    crops before resizing back to the original image."""

    def __init__(self, data: np.ndarray, original_width: int,
                 original_height: int,
                 padding: tuple[float, float, float, float],
                 default_max_size: int = 2048):
        self.data = np.asarray(data)
        self.height, self.width = self.data.shape[:2]
        self.original_width = original_width
        self.original_height = original_height
        self.padding = padding
        #: Default ``max_size`` of :meth:`upsample`, from
        #: ``SegmentationConfig.max_output_size`` (`face_types.dart:244`).
        self.default_max_size = default_max_size

    def upsample(self, target_width: Optional[int] = None,
                 target_height: Optional[int] = None,
                 max_size: Optional[int] = None) -> "SegmentationMask":
        """Crops the letterbox padding and resizes bilinearly to the target
        size (default: the original image's), the longer side capped at
        ``max_size`` (default :attr:`default_max_size`;
        `face_types.dart:345-420`)."""
        if max_size is None:
            max_size = self.default_max_size
        tw = target_width or self.original_width
        th = target_height or self.original_height
        max_dim = max(tw, th)
        scale = max_size / max_dim if (max_size > 0 and max_dim > max_size) \
            else 1.0
        fw, fh = _dart_round(tw * scale), _dart_round(th * scale)
        out = crop_valid_and_resize(self.data, self.width, self.height,
                                    self.padding, fw, fh)
        return SegmentationMask(out.astype(np.float32), self.original_width,
                                self.original_height, (0.0, 0.0, 0.0, 0.0),
                                default_max_size=self.default_max_size)

    def confidence_at(self, x_norm: float, y_norm: float) -> float:
        x = min(max(int(x_norm * self.width), 0), self.width - 1)
        y = min(max(int(y_norm * self.height), 0), self.height - 1)
        return float(self.data[y, x])

    def to_uint8(self) -> np.ndarray:
        """8-bit grayscale mask (clamp to [0, 1], x255, round)."""
        return np.round(np.clip(self.data, 0.0, 1.0) * 255).astype(np.uint8)

    def to_binary(self, threshold: float = 0.5) -> np.ndarray:
        """255 where data >= threshold, else 0."""
        return np.where(self.data >= threshold, 255, 0).astype(np.uint8)

    def to_rgba(self, foreground=(255, 255, 255, 255),
                background=(0, 0, 0, 0), threshold: float = 0.5
                ) -> np.ndarray:
        """[H, W, 4] RGBA visualization (`face_types.dart:434`)."""
        m = (self.data >= threshold)[..., None]
        return np.where(m, np.asarray(foreground, np.uint8),
                        np.asarray(background, np.uint8))

    def serialize(self, fmt: str = "float32",
                  binary_threshold: float = 0.5) -> dict:
        """A serializable dict in format float32, uint8 or binary
        (`face_detector.dart:1735-1771`)."""
        base = {"width": self.width, "height": self.height,
                "original_width": self.original_width,
                "original_height": self.original_height,
                "padding": tuple(self.padding), "data_format": fmt,
                "default_max_size": self.default_max_size}
        if fmt == "float32":
            base["data"] = self.data.astype(np.float32).tobytes()
        elif fmt == "uint8":
            base["data"] = self.to_uint8().tobytes()
        elif fmt == "binary":
            base["data"] = self.to_binary(binary_threshold).tobytes()
            base["binary_threshold"] = binary_threshold
        else:
            raise ValueError(f"Unknown data format: {fmt}")
        if isinstance(self, MulticlassSegmentationMask):
            base["class_data"] = self.class_data.astype(np.float32).tobytes()
        return base

    @staticmethod
    def deserialize(d: dict) -> "SegmentationMask":
        """Inverse of :meth:`serialize` (`face_detector.dart:1773-1827`)."""
        w, h = d["width"], d["height"]
        fmt = d.get("data_format", "float32")
        if fmt == "float32":
            data = np.frombuffer(d["data"], np.float32).reshape(h, w).copy()
        elif fmt == "uint8":
            data = (np.frombuffer(d["data"], np.uint8)
                    .reshape(h, w).astype(np.float32) / 255.0)
        elif fmt == "binary":
            data = (np.frombuffer(d["data"], np.uint8).reshape(h, w) == 255
                    ).astype(np.float32)
        else:
            raise ValueError(f"Unknown data format: {fmt}")
        dms = d.get("default_max_size", 2048)
        if "class_data" in d:
            class_data = np.frombuffer(
                d["class_data"], np.float32).reshape(h, w, 6).copy()
            return MulticlassSegmentationMask(
                data, d["original_width"], d["original_height"],
                tuple(d["padding"]), class_data=class_data,
                default_max_size=dms)
        return SegmentationMask(data, d["original_width"],
                                d["original_height"], tuple(d["padding"]),
                                default_max_size=dms)


class MulticlassSegmentationMask(SegmentationMask):
    """Adds the per-class probabilities ([H, W, 6], softmaxed)."""

    def __init__(self, data, original_width, original_height, padding,
                 class_data: np.ndarray, default_max_size: int = 2048):
        super().__init__(data, original_width, original_height, padding,
                         default_max_size=default_max_size)
        self.class_data = np.asarray(class_data)

    def class_mask(self, cls: SegmentationClass) -> np.ndarray:
        return self.class_data[..., int(cls)]

    @property
    def hair_mask(self):
        return self.class_mask(SegmentationClass.HAIR)

    @property
    def body_skin_mask(self):
        return self.class_mask(SegmentationClass.BODY_SKIN)

    @property
    def face_skin_mask(self):
        return self.class_mask(SegmentationClass.FACE_SKIN)

    @property
    def clothes_mask(self):
        return self.class_mask(SegmentationClass.CLOTHES)

    @property
    def other_mask(self):
        return self.class_mask(SegmentationClass.OTHER)

    @property
    def background_mask(self):
        return self.class_mask(SegmentationClass.BACKGROUND)


class SelfieSegmentation:
    """The segmentation pipeline of one segmenter network.

    ``model`` is the converted segmenter; it runs on ``device`` (``cuda``
    unless the caller passes ``device="cpu"``).  ``mask_dtype`` "uint8"
    quantizes the probabilities to 1/255 steps on the device, a quarter
    of the readback bytes (the reference's uint8 serialize format,
    `face_detector.dart:1735-1771`).
    """

    def __init__(self, model: ConvertedModel, multiclass: bool = False, *,
                 mask_dtype: str = "float32", max_output_size: int = 2048,
                 device=None):
        if mask_dtype not in ("float32", "uint8"):
            raise ValueError(f"mask_dtype must be 'float32' or 'uint8', "
                             f"got {mask_dtype!r}")
        self.device = resolve_device(device)
        fp32_on_the_card(self.device)
        self.model = model.to(self.device).eval()
        self.multiclass = multiclass
        self.mask_dtype = mask_dtype
        self.max_output_size = max_output_size
        _, self.in_h, self.in_w, _ = model.input_shapes[0]

    def place_on(self, device) -> None:
        """Pinning the segmenter to another card (the JAX package's
        multi-chip analog of the reference's segmentation isolate) waits
        for the scale-out slice."""
        raise NotImplementedError(
            "SelfieSegmentation.place_on is not ported yet (ROADMAP §1 "
            "item 7)")

    def _planes(self, model: ConvertedModel, images: torch.Tensor, lbp
                ) -> torch.Tensor:
        """The device program: letterbox, the net, then the person plane
        ([B, h, w, 1]) or the six softmax planes, as uint8 where asked."""
        (raw,) = model(letterbox_image(images, lbp))
        raw = raw.reshape(raw.shape[0], self.in_h, self.in_w, -1)
        out = torch.softmax(raw, dim=-1) if self.multiclass else raw[..., :1]
        if self.mask_dtype == "uint8":
            out = torch.round(torch.clamp(out, 0.0, 1.0) * 255.0
                              ).to(torch.uint8)
        return out

    def dispatch(self, images):
        """Queues the segmentation of a [B, H, W, C] (or one [H, W, C])
        RGB batch, numpy or tensor, and starts the planes' copy to pinned
        host memory; returns the handle :meth:`materialize` takes.  Raises
        RuntimeError after :meth:`dispose`."""
        model = self.model  # a concurrent dispose() must give RuntimeError
        if model is None:
            raise RuntimeError("SelfieSegmentation has been disposed")
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        # One [H, W, C] image only for a channel-shaped last axis; any
        # other 3-D array is a [B, H, W] grayscale batch.
        if images.ndim == 3 and images.shape[-1] in (1, 3, 4):
            images = images[None]
        images = normalize_channels(images, self.device)
        b, h, w, _ = images.shape
        if h < MIN_SEGMENTATION_INPUT_SIZE or w < MIN_SEGMENTATION_INPUT_SIZE:
            raise ValueError(
                f"image {w}x{h} is smaller than minimum "
                f"{MIN_SEGMENTATION_INPUT_SIZE}x{MIN_SEGMENTATION_INPUT_SIZE}")
        lbp = letterbox_params(h, w, self.in_h, self.in_w)
        with torch.inference_mode():
            host, event = download_async(self._planes(model, images, lbp))
        return host, event, lbp, b, w, h

    def materialize(self, handle) -> list[SegmentationMask]:
        """Waits for a :meth:`dispatch` handle's copy and builds the mask
        objects (multiclass: person = 1 - background)."""
        host, event, lbp, b, w, h = handle
        if event is not None:
            event.synchronize()
        planes = host.numpy()
        if planes.dtype == np.uint8:
            planes = planes.astype(np.float32) * (1.0 / 255.0)
        masks: list[SegmentationMask] = []
        for i in range(b):
            if self.multiclass:
                masks.append(MulticlassSegmentationMask(
                    1.0 - planes[i, ..., 0], w, h, lbp.padding,
                    class_data=planes[i],
                    default_max_size=self.max_output_size))
            else:
                masks.append(SegmentationMask(
                    planes[i, ..., 0], w, h, lbp.padding,
                    default_max_size=self.max_output_size))
        return masks

    def __call__(self, images) -> list[SegmentationMask]:
        """Segments a [B, H, W, 3] RGB batch (uint8 or float 0..255)."""
        return self.materialize(self.dispatch(images))

    def call_from_bytes(self, data: bytes) -> SegmentationMask:
        """Decodes an encoded image and segments it (`callFromBytes`,
        selfie_segmentation.dart:586)."""
        return self(decode_image(data)[None])[0]

    def dispose(self) -> None:
        """Drops the network; later calls raise
        (`selfie_segmentation.dart:733`)."""
        self.model = None

    def dispose_async(self) -> None:
        self.dispose()
