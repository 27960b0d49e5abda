"""SSD anchor generation for the BlazeFace detector variants.

Reproduces the anchor layout consumed by the reference pipeline
(`flutter_litert generateAnchors`, configured by
`lib/src/shared/face_model_config.dart:80-125`): MediaPipe's
SsdAnchorsCalculator restricted to the options the face models use
(aspect_ratios=[1.0], anchor_offset=0.5, no reduce_boxes_in_lowest_layer).
Only the anchor *centers* are used downstream — the reference's decode
(`lib/src/web/detection_decode.dart:44-88`) divides raw values by the input
size and adds the center, never the anchor extent.

Anchors are a compile-time constant: generated once in numpy and baked into
the jitted detection program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["SSDAnchorOptions", "generate_anchors", "SSD_FRONT", "SSD_BACK",
           "SSD_FULL", "anchor_options_for"]


@dataclasses.dataclass(frozen=True)
class SSDAnchorOptions:
    num_layers: int
    min_scale: float
    max_scale: float
    input_size_height: int
    input_size_width: int
    anchor_offset_x: float
    anchor_offset_y: float
    strides: tuple[int, ...]
    aspect_ratios: tuple[float, ...] = (1.0,)
    interpolated_scale_aspect_ratio: float = 1.0
    fixed_anchor_size: bool = True


# `lib/src/shared/face_model_config.dart:80-93` (kSsdFront)
SSD_FRONT = SSDAnchorOptions(
    num_layers=4, min_scale=0.1464, max_scale=0.9,
    input_size_height=128, input_size_width=128,
    anchor_offset_x=0.5, anchor_offset_y=0.5,
    strides=(8, 16, 16, 16),
)

# `lib/src/shared/face_model_config.dart:96-109` (kSsdBack)
SSD_BACK = SSDAnchorOptions(
    num_layers=4, min_scale=0.1464, max_scale=0.9,
    input_size_height=256, input_size_width=256,
    anchor_offset_x=0.5, anchor_offset_y=0.5,
    strides=(16, 32, 32, 32),
)

# `lib/src/shared/face_model_config.dart:112-125` (kSsdFull)
SSD_FULL = SSDAnchorOptions(
    num_layers=1, min_scale=0.1171875, max_scale=0.75,
    input_size_height=192, input_size_width=192,
    anchor_offset_x=0.5, anchor_offset_y=0.5,
    strides=(4,),
    interpolated_scale_aspect_ratio=0.0,
    fixed_anchor_size=False,
)


def _calc_scale(min_scale, max_scale, stride_index, num_strides):
    if num_strides == 1:
        return (min_scale + max_scale) * 0.5
    return min_scale + (max_scale - min_scale) * stride_index / (num_strides - 1)


def generate_anchors(opts: SSDAnchorOptions) -> np.ndarray:
    """Returns anchor centers as a float32 array of shape [num_anchors, 2].

    Column order is (x_center, y_center), both normalized to [0, 1].
    """
    anchors: list[tuple[float, float]] = []
    layer_id = 0
    n = opts.num_layers
    while layer_id < n:
        anchor_scales: list[float] = []
        last = layer_id
        while last < n and opts.strides[last] == opts.strides[layer_id]:
            scale = _calc_scale(opts.min_scale, opts.max_scale, last, n)
            for _ar in opts.aspect_ratios:
                anchor_scales.append(scale)
            if opts.interpolated_scale_aspect_ratio > 0.0:
                scale_next = (
                    1.0 if last == n - 1
                    else _calc_scale(opts.min_scale, opts.max_scale, last + 1, n)
                )
                anchor_scales.append(math.sqrt(scale * scale_next))
            last += 1

        stride = opts.strides[layer_id]
        feat_h = -(-opts.input_size_height // stride)
        feat_w = -(-opts.input_size_width // stride)
        for y in range(feat_h):
            y_center = (y + opts.anchor_offset_y) / feat_h
            for x in range(feat_w):
                x_center = (x + opts.anchor_offset_x) / feat_w
                for _ in anchor_scales:
                    anchors.append((x_center, y_center))
        layer_id = last

    return np.asarray(anchors, dtype=np.float32)


def anchor_options_for(variant: str) -> SSDAnchorOptions:
    """Maps a detector-variant name to its anchor options.

    Mirrors `ssdOptionsFor` (`face_model_config.dart:128-135`):
    front/short -> SSD_FRONT, back -> SSD_BACK, full/full_sparse -> SSD_FULL.
    """
    return {
        "front": SSD_FRONT,
        "short": SSD_FRONT,
        "short_range": SSD_FRONT,
        "back": SSD_BACK,
        "back_camera": SSD_BACK,
        "full": SSD_FULL,
        "full_sparse": SSD_FULL,
    }[variant]
