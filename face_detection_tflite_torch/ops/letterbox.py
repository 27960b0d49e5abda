"""Letterbox preprocessing on batched tensors.

Port of the JAX package's ``ops/letterbox.py``.  The reference letterboxes
on the host with OpenCV (`convertImageToTensor`,
`lib/src/util/helpers.dart:303-368`): aspect-preserving INTER_LINEAR
resize, black padding, then [-1, 1] normalization.  Here the resize is the
cv2-exact separable 2-tap gather over a ``[B, H, W, C]`` batch, in plain
PyTorch on every device (its Hopper kernel is queued, ROADMAP §2 K3).

All geometry (scale, new size, pad split) is static per (src, dst) shape
pair, mirroring `computeLetterboxParams` from flutter_litert.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["LetterboxParams", "letterbox_params", "resize_matrix",
           "resize_taps",
           "resize_bilinear_exact", "normalize_image", "letterbox_image"]


@dataclasses.dataclass(frozen=True)
class LetterboxParams:
    """Static letterbox geometry for one (src, dst) shape pair."""

    src_h: int
    src_w: int
    dst_h: int
    dst_w: int
    new_h: int
    new_w: int
    pad_top: int
    pad_bottom: int
    pad_left: int
    pad_right: int

    @property
    def padding(self) -> tuple[float, float, float, float]:
        """Normalized (top, bottom, left, right), as `ImageTensor.padding`."""
        return (
            self.pad_top / self.dst_h,
            self.pad_bottom / self.dst_h,
            self.pad_left / self.dst_w,
            self.pad_right / self.dst_w,
        )


def letterbox_params(src_h: int, src_w: int, dst_h: int, dst_w: int
                     ) -> LetterboxParams:
    """Aspect-preserving fit of (src_h, src_w) into (dst_h, dst_w).

    Sizes round like Dart's ``.round()`` — half AWAY from zero — not
    Python's half-to-even; the two differ only at exact .5 products (e.g.
    170x512 -> 128 gives 42.5), where they shift the resize and pad split
    by a pixel.
    """
    scale = min(dst_w / src_w, dst_h / src_h)

    def _dart_round(x: float) -> int:
        return int(np.floor(x + 0.5))

    new_w = min(dst_w, max(1, _dart_round(src_w * scale)))
    new_h = min(dst_h, max(1, _dart_round(src_h * scale)))
    pad_w = dst_w - new_w
    pad_h = dst_h - new_h
    pad_left = pad_w // 2
    pad_top = pad_h // 2
    return LetterboxParams(
        src_h=src_h, src_w=src_w, dst_h=dst_h, dst_w=dst_w,
        new_h=new_h, new_w=new_w,
        pad_top=pad_top, pad_bottom=pad_h - pad_top,
        pad_left=pad_left, pad_right=pad_w - pad_left,
    )


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``[out, in]`` float32 bilinear weights with cv2.INTER_LINEAR
    semantics (the dense form of :func:`resize_taps`; the virtual
    background of ``utils/render.py`` resizes with it)."""
    m = np.zeros((out_size, in_size), np.float32)
    lo, hi, frac = resize_taps(in_size, out_size)
    for o in range(out_size):
        m[o, lo[o]] += 1.0 - frac[o]
        m[o, hi[o]] += frac[o]
    return m


def resize_taps(in_size: int, out_size: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, frac) 2-tap bilinear sampling plan, cv2 semantics: source
    coordinate ``(x + 0.5) * in/out - 0.5`` clamped to the border."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


@functools.lru_cache(maxsize=None)
def _device_taps(in_size: int, out_size: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`resize_taps` as tensors on ``device``, uploaded once per
    (in size, out size, device): a host-to-device copy in every call would
    wait for the stream.  Never evicted (a few KB an entry): a captured
    program (``pipeline/graphs.py``) reads these tensors at every
    replay, so their memory must outlive it."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in resize_taps(in_size, out_size))


def resize_bilinear_exact(x: torch.Tensor, out_h: int, out_w: int
                          ) -> torch.Tensor:
    """cv2.INTER_LINEAR-exact separable resize of ``[B, H, W, C]`` to
    float32 ``[B, out_h, out_w, C]``.  The vertical pass gathers rows in
    the source dtype and casts after the gather (exact for uint8)."""
    h, w = x.shape[1], x.shape[2]
    if out_h != h:
        lo, hi, frac = _device_taps(h, out_h, x.device)
        f = frac[:, None, None]
        x = (x.index_select(1, lo).float() * (1.0 - f)
             + x.index_select(1, hi).float() * f)
    else:
        x = x.float()
    if out_w != w:
        lo, hi, frac = _device_taps(w, out_w, x.device)
        f = frac[None, :, None]
        x = x.index_select(2, lo) * (1.0 - f) + x.index_select(2, hi) * f
    return x


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """uint8/float [0, 255] RGB -> float32 [-1, 1] (`helpers.dart:377-421`)."""
    return img.float() * (1.0 / 127.5) - 1.0


def letterbox_image(images: torch.Tensor, params: LetterboxParams
                    ) -> torch.Tensor:
    """Letterboxes ``[B, H, W, 3]`` images to ``[B, dst_h, dst_w, 3]`` in
    [-1, 1]: resize, normalize, then pad with -1 (black)."""
    x = normalize_image(resize_bilinear_exact(images, params.new_h,
                                              params.new_w))
    return F.pad(x, (0, 0, params.pad_left, params.pad_right,
                     params.pad_top, params.pad_bottom), value=-1.0)
