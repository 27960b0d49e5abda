"""Batched rotated-square ROI extraction fused with the [-1, 1] normalize:
the Hopper kernel (``csrc/warp.cu``) and its plain PyTorch version.

Replaces the JAX package's ``ops/warp.py::_bilinear_sample`` reached
through ``extract_rois``, followed by ``ops/letterbox.py::normalize_image``
(the mesh stage's crop, `helpers.dart:583-625`).  Geometry, as there:

* ``size`` rounds to whole pixels with Dart rounding, ``floor(x + 0.5)``;
* ``scale = out_size / size``; the source center lands at
  ``out_size/2 + 0.5*(scale - 1)`` (crop-then-cv2-resize alignment);
* destination -> source: ``src = c + R(theta)^T (dst - center) / scale``;
* four taps, each with its own inside-mask; outside taps read 0, which
  normalizes to -1; an optional per-ROI mirror in x.

Sine and cosine are computed once per ROI by :func:`extract_rois_normalized`
and handed to both versions, so they sample at the same coordinates.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import build as _build
from .letterbox import normalize_image

__all__ = ["extract_rois_normalized", "warp_normalize",
           "warp_normalize_plain", "extract_rois"]

_INV_127_5 = 1.0 / 127.5
#: Largest crop the kernel takes: it keeps two floats per output column in
#: shared memory, which stays within 48 KB up to this size
#: (``csrc/warp.cu::kMaxOutSize``).
MAX_OUT_SIZE = 4096


def _bilinear_sample(frames: torch.Tensor, sx: torch.Tensor,
                     sy: torch.Tensor) -> torch.Tensor:
    """Samples ``frames [B, H, W, C]`` at ``sx, sy [B, F, S, S]`` ->
    float32 ``[B, F, S, S, C]``; taps outside the image read 0."""
    b, h, w, c = frames.shape
    flat = frames.reshape(b, h * w, c)
    bidx = torch.arange(b, device=frames.device)[:, None, None, None]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi):
        yc = torch.clamp(yi, 0, h - 1)
        xc = torch.clamp(xi, 0, w - 1)
        val = flat[bidx, yc * w + xc].float()
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return torch.where(inside[..., None], val, 0.0)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    wx = fx[..., None]
    wy = fy[..., None]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def extract_rois(frames: torch.Tensor, cx, cy, sizes, cos_t, sin_t, *,
                 out_size: int, flip_x: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """``[B, H, W, C]`` frames and per-ROI ``[B, F]`` parameters ->
    ``[B, F, S, S, C]`` float32 crops (the JAX ``extract_rois`` on a batch,
    given cos/sin of the ROI angle).  ``flip_x [B, F]`` mirrors a crop's
    columns under a per-ROI select."""
    size_int = torch.clamp_min(torch.floor(sizes + 0.5), 1.0)
    # A true division: ``out_size / size_int`` would multiply by the
    # reciprocal and round differently from the kernel and from XLA.
    scale = torch.full_like(size_int, out_size) / size_int
    out_center = out_size / 2.0 + 0.5 * (scale - 1.0)
    grid = torch.arange(out_size, dtype=torch.float32, device=frames.device)
    sc = scale[..., None, None]
    oc = out_center[..., None, None]
    dx = (grid[None, None, None, :] - oc) / sc     # [B, F, 1, S]
    dy = (grid[None, None, :, None] - oc) / sc     # [B, F, S, 1]
    ct = cos_t[..., None, None]
    st = sin_t[..., None, None]
    sx = cx[..., None, None] + ct * dx + st * dy
    sy = cy[..., None, None] - st * dx + ct * dy
    out = _bilinear_sample(frames, sx, sy)
    if flip_x is not None:
        out = torch.where(flip_x[..., None, None, None].bool(),
                          out.flip(3), out)
    return out


def warp_normalize_plain(frames, cx, cy, sizes, cos_t, sin_t, *,
                         out_size: int, flip: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of the kernel: :func:`extract_rois` then the
    [-1, 1] normalize."""
    return normalize_image(extract_rois(frames, cx, cy, sizes, cos_t, sin_t,
                                        out_size=out_size, flip_x=flip))


def warp_normalize(frames: torch.Tensor, cx, cy, sizes, cos_t, sin_t, *,
                   out_size: int, flip: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """ROI warp + normalize: ``frames [B, H, W, 3]`` (uint8 or float32
    0..255), per-ROI ``[B, F]`` float32 parameters, optional ``flip
    [B, F]`` -> ``[B, F, S, S, 3]`` float32 in [-1, 1].  The kernel for
    CUDA tensors (one launch), the plain version for CPU tensors.
    ``warp_normalize.launches`` counts kernel launches, and
    ``warp_normalize.launches_by_size`` counts them per ``out_size``.
    ``out_size`` is 1 to :data:`MAX_OUT_SIZE` on every device."""
    if not 1 <= out_size <= MAX_OUT_SIZE:
        raise ValueError(f"warp_normalize: out_size must be 1 to "
                         f"{MAX_OUT_SIZE}, got {out_size}")
    if frames.device.type == "cpu":
        return warp_normalize_plain(frames, cx, cy, sizes, cos_t, sin_t,
                                    out_size=out_size, flip=flip)
    if frames.device.type != "cuda":
        raise ValueError(f"warp_normalize: unsupported device "
                         f"{frames.device}")
    if frames.dim() != 4 or frames.shape[3] != 3:
        raise ValueError(f"warp_normalize: frames must be [B, H, W, 3], got "
                         f"{tuple(frames.shape)}")
    if frames.dtype not in (torch.uint8, torch.float32):
        raise TypeError("warp_normalize: frames must be uint8 or float32")
    b, h, w, _ = frames.shape
    if h < 1 or w < 1:
        raise ValueError("warp_normalize: frames must hold at least one "
                         "pixel")
    params = (cx, cy, sizes, cos_t, sin_t)
    f = cx.shape[1] if cx.dim() == 2 else -1
    for p in params + ((flip,) if flip is not None else ()):
        if p.dim() != 2 or tuple(p.shape) != (b, f):
            raise ValueError("warp_normalize: ROI parameters must be [B, F]")
        if not p.is_contiguous() or p.device != frames.device:
            raise ValueError("warp_normalize: ROI parameters must be "
                             "contiguous and on the frames' device")
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError("warp_normalize: ROI parameters must be float32")
    if flip is not None and flip.dtype not in (torch.bool, torch.uint8):
        raise TypeError("warp_normalize: flip must be bool or uint8")
    if not frames.is_contiguous():
        raise ValueError("warp_normalize: frames must be contiguous")
    out = torch.empty((b, f, out_size, out_size, 3), dtype=torch.float32,
                      device=frames.device)
    if b and f:
        lib = _build.load()
        entry = (lib.fdt_warp_normalize_u8 if frames.dtype == torch.uint8
                 else lib.fdt_warp_normalize_f32)
        rc = entry(frames.data_ptr(), b, h, w, cx.data_ptr(), cy.data_ptr(),
                   sizes.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
                   None if flip is None else flip.view(torch.uint8).data_ptr(),
                   f, out_size, _INV_127_5, out.data_ptr(),
                   frames.device.index if frames.device.index is not None
                   else torch.cuda.current_device(),
                   torch.cuda.current_stream(frames.device).cuda_stream)
        _build.check(rc, "warp_normalize")
        _build.count_launch(warp_normalize, out_size)
    return out


warp_normalize.launches = 0
#: Kernel launches per crop size (192 the mesh site, 64 the iris site).
warp_normalize.launches_by_size = {}


def extract_rois_normalized(frames: torch.Tensor, cx, cy, sizes, theta, *,
                            out_size: int,
                            flip: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Mesh-stage crops: ROI angle ``theta [B, F]`` -> cos/sin once per
    ROI, then :func:`warp_normalize`."""
    return warp_normalize(frames, cx.contiguous(), cy.contiguous(),
                          sizes.contiguous(), torch.cos(theta).contiguous(),
                          torch.sin(theta).contiguous(), out_size=out_size,
                          flip=None if flip is None else flip.contiguous())
