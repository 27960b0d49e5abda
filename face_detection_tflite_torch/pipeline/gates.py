"""Detection gates as mask updates on the fixed-size detection slab.

Port of the JAX package's ``pipeline/gates.py`` (semantics of
`lib/src/shared/face_gates.dart`): inclusive comparisons, pixel-space width
clipping (`boxVisibleWidthFraction`, face_gates.dart:115).
"""

from __future__ import annotations

import math

import torch

__all__ = ["validate_face_gates", "box_visible_width_fraction",
           "apply_detection_gates_mask"]


def validate_face_gates(min_score: float, min_face_size: float,
                        min_face_presence_confidence: float = 0.0) -> None:
    """Fail-fast validation (`face_gates.dart:31-58`): values in [0, 1]."""
    for name, v in (("min_score", min_score),
                    ("min_face_size", min_face_size),
                    ("min_face_presence_confidence",
                     min_face_presence_confidence)):
        if math.isnan(v) or v < 0.0 or v > 1.0:
            raise ValueError(
                f"{name} must be in the inclusive range [0.0, 1.0], got {v}")


def box_visible_width_fraction(box: torch.Tensor, image_width: float):
    """Visible width of normalized ``[..., 4]`` boxes as a fraction of the
    image width (`face_gates.dart:115-128`)."""
    if image_width <= 0:
        return torch.zeros_like(box[..., 0])
    left = box[..., 0] * image_width
    right = box[..., 2] * image_width
    visible = torch.clamp_max(right, image_width) - torch.clamp_min(left, 0.0)
    return torch.where(visible > 0, visible / image_width, 0.0)


def apply_detection_gates_mask(valid, scores, boxes, *, min_score: float,
                               min_face_size: float, image_width: float):
    """Early gate (`applyDetectionGates`, face_gates.dart:130-146):
    detections failing minScore / minFaceSize are invalidated before any
    per-face stage runs."""
    if min_score <= 0.0 and min_face_size <= 0.0:
        return valid
    keep = valid & (scores >= min_score)
    if min_face_size > 0.0:
        keep = keep & (box_visible_width_fraction(boxes, image_width)
                       >= min_face_size)
    return keep
