"""BlazeFace postprocessing on batched tensors: decode + weighted NMS.

Port of the JAX package's ``ops/detections.py``.  Semantics matched to the
reference (`face_detection_model.dart:431-492`, `helpers.dart:101-221`):

* score = sigmoid(clip(logit, ±100)); valid = score >= MIN_SCORE and a
  non-degenerate box;
* box decode: raw / input_size + anchor center, keypoints likewise;
* weighted NMS: score-sorted greedy clustering with STRICT IoU >
  threshold; the emitted box is the score-weighted average of the
  cluster, score and keypoints come from the leader;
* letterbox removal: (v - pad) / (1 - pad_lo - pad_hi) per axis.

Every function takes a leading batch axis.  The NMS core runs through
:func:`..ops.nms.nms_core` (the Hopper kernel on CUDA tensors).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..pipeline.config import (MIN_SCORE, MIN_SUPPRESSION_THRESHOLD,
                               RAW_SCORE_LIMIT)
from .nms import nms_core

__all__ = ["decode_detections", "weighted_nms", "remove_letterbox",
           "NMS_IOU"]

NMS_IOU = MIN_SUPPRESSION_THRESHOLD


def decode_detections(raw_boxes: torch.Tensor, raw_scores: torch.Tensor,
                      anchors: torch.Tensor, input_size: float):
    """``raw_boxes [B, A, 16]``, ``raw_scores [B, A]`` (or ``[B, A, 1]``),
    ``anchors [A, 2]`` -> boxes ``[B, A, 4]`` (xmin, ymin, xmax, ymax),
    keypoints ``[B, A, 6, 2]``, scores ``[B, A]``, valid ``[B, A]``."""
    raw_scores = raw_scores.reshape(raw_scores.shape[0], raw_boxes.shape[1])
    scaled = raw_boxes / input_size
    cxy = scaled[..., 0:2] + anchors
    wh = scaled[..., 2:4]
    kp = scaled[..., 4:16].reshape(*scaled.shape[:2], 6, 2) + \
        anchors[:, None, :]
    half = wh * 0.5
    boxes = torch.cat([cxy - half, cxy + half], dim=-1)
    scores = torch.sigmoid(torch.clamp(raw_scores, -RAW_SCORE_LIMIT,
                                       RAW_SCORE_LIMIT))
    valid = (scores >= MIN_SCORE) & (wh[..., 0] > 0) & (wh[..., 1] > 0)
    return boxes, kp, scores, valid


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i], ...]`` for a ``[B, k]`` index."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _topk_candidates(boxes, keypoints, scores, valid, k: int):
    """Top-k candidates in descending score order.  A stable descending
    sort keeps equal scores in index order, as ``lax.top_k`` does."""
    masked = torch.where(valid, scores, torch.full_like(scores, -1.0))
    top_scores, top_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    return (_take(boxes, top_idx).contiguous(), _take(keypoints, top_idx),
            top_scores.contiguous(), top_scores > 0.0)


def _emit_slab(leader, blended, top_kp, top_scores, k: int, d: int):
    """Leader mask + blended boxes -> the fixed ``[B, D]`` slab: the first
    d leaders in score (= index) order, zero-padded."""
    idx = torch.arange(k, device=leader.device)
    order = torch.argsort(torch.where(leader, idx, k + idx), dim=1,
                          stable=True)[:, :d]
    out_valid = torch.gather(leader, 1, order)
    out_boxes = torch.where(out_valid[..., None], _take(blended, order), 0.0)
    out_kp = torch.where(out_valid[..., None, None], _take(top_kp, order),
                         0.0)
    out_scores = torch.where(out_valid, torch.gather(top_scores, 1, order),
                             0.0)
    if k < d:
        pad = d - k
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_kp = torch.nn.functional.pad(out_kp, (0, 0, 0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_valid = torch.nn.functional.pad(out_valid, (0, pad))
    return out_boxes, out_kp, out_scores, out_valid


def weighted_nms(boxes, keypoints, scores, valid, *, max_detections: int,
                 num_candidates: Optional[int] = None,
                 iou_threshold: float = NMS_IOU):
    """Fixed-shape weighted (blended) NMS over a batch.

    ``num_candidates`` defaults to ALL anchors, as the reference clusters
    every anchor above threshold.  Returns (boxes ``[B, D, 4]``, keypoints
    ``[B, D, 6, 2]``, scores ``[B, D]``, valid ``[B, D]``).
    """
    n = scores.shape[1]
    k = n if num_candidates is None else min(num_candidates, n)
    top_boxes, top_kp, top_scores, top_valid = _topk_candidates(
        boxes, keypoints, scores, valid, k)
    leader, blended = nms_core(top_boxes, top_scores, top_valid,
                               iou_threshold)
    return _emit_slab(leader, blended, top_kp, top_scores, k,
                      max_detections)


def remove_letterbox(boxes, keypoints, padding):
    """Undoes letterbox padding: (v - pad_lo) / (1 - pad_lo - pad_hi).
    ``padding`` is (top, bottom, left, right) in normalized units."""
    pt, pb, pl, pr = padding
    sx = 1.0 - (pl + pr)
    sy = 1.0 - (pt + pb)
    boxes = torch.stack([
        (boxes[..., 0] - pl) / sx,
        (boxes[..., 1] - pt) / sy,
        (boxes[..., 2] - pl) / sx,
        (boxes[..., 3] - pt) / sy,
    ], dim=-1)
    keypoints = torch.stack([
        (keypoints[..., 0] - pl) / sx,
        (keypoints[..., 1] - pt) / sy,
    ], dim=-1)
    return boxes, keypoints
