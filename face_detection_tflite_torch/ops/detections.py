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

Every function takes a leading batch axis.  :func:`detection_postprocess`
runs all of it, from the detector's raw outputs to the ``[B, D]`` slab: one
launch of the Hopper kernel (``csrc/nms.cu``) on CUDA tensors,
:func:`detection_postprocess_plain` on CPU tensors.  :func:`weighted_nms`
runs its core through :func:`..ops.nms.nms_core`.

The divisions are true divisions on every device: a Python-float divisor
makes PyTorch's CUDA kernel multiply by its reciprocal instead, which can
differ by an ulp, so the divisors here are tensors on the input's device.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import build as _build
from ..pipeline.config import (MIN_SCORE, MIN_SUPPRESSION_THRESHOLD,
                               RAW_SCORE_LIMIT)
from .nms import nms_core, nms_core_plain

__all__ = ["decode_detections", "weighted_nms", "remove_letterbox",
           "detection_postprocess", "detection_postprocess_plain",
           "NMS_IOU", "MAX_ANCHORS"]

NMS_IOU = MIN_SUPPRESSION_THRESHOLD

#: Anchors per image the kernel takes (30 bytes each and an 8-byte sort key
#: per power-of-two slot in shared memory); BlazeFace has at most 2304.
MAX_ANCHORS = 4096


def _divisor(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor on ``like``'s device, so that dividing
    by it is a true division there too."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def decode_detections(raw_boxes: torch.Tensor, raw_scores: torch.Tensor,
                      anchors: torch.Tensor, input_size: float):
    """``raw_boxes [B, A, 16]``, ``raw_scores [B, A]`` (or ``[B, A, 1]``),
    ``anchors [A, 2]`` -> boxes ``[B, A, 4]`` (xmin, ymin, xmax, ymax),
    keypoints ``[B, A, 6, 2]``, scores ``[B, A]``, valid ``[B, A]``."""
    raw_scores = raw_scores.reshape(raw_scores.shape[0], raw_boxes.shape[1])
    scaled = raw_boxes / _divisor(input_size, raw_boxes)
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
                 iou_threshold: float = NMS_IOU, core=nms_core):
    """Fixed-shape weighted (blended) NMS over a batch.

    ``num_candidates`` defaults to ALL anchors, as the reference clusters
    every anchor above threshold.  ``core`` computes the leader mask and
    blended boxes (:func:`..ops.nms.nms_core` or its plain version).
    Returns (boxes ``[B, D, 4]``, keypoints ``[B, D, 6, 2]``, scores
    ``[B, D]``, valid ``[B, D]``).
    """
    n = scores.shape[1]
    k = n if num_candidates is None else min(num_candidates, n)
    top_boxes, top_kp, top_scores, top_valid = _topk_candidates(
        boxes, keypoints, scores, valid, k)
    leader, blended = core(top_boxes, top_scores, top_valid, iou_threshold)
    return _emit_slab(leader, blended, top_kp, top_scores, k,
                      max_detections)


def remove_letterbox(boxes, keypoints, padding):
    """Undoes letterbox padding: (v - pad_lo) / (1 - pad_lo - pad_hi).
    ``padding`` is (top, bottom, left, right) in normalized units."""
    pt, pb, pl, pr = padding
    sx = _divisor(1.0 - (pl + pr), boxes)
    sy = _divisor(1.0 - (pt + pb), boxes)
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


def detection_postprocess_plain(raw_boxes, raw_scores, anchors, input_size,
                                padding, *, max_detections: int,
                                num_candidates: Optional[int] = None,
                                iou_threshold: float = NMS_IOU):
    """decode -> weighted NMS (plain core) -> letterbox removal: the JAX
    package's ``detection_postprocess`` on a batch, in plain PyTorch.

    ``raw_boxes [B, A, 16]``, ``raw_scores [B, A]`` (or ``[B, A, 1]``),
    ``anchors [A, 2]``, ``padding`` (top, bottom, left, right) -> boxes
    ``[B, D, 4]``, keypoints ``[B, D, 6, 2]``, scores ``[B, D]``, valid
    ``[B, D]`` with D = ``max_detections``.
    """
    boxes, kp, scores, valid = decode_detections(raw_boxes, raw_scores,
                                                 anchors, input_size)
    boxes, kp, scores, valid = weighted_nms(
        boxes, kp, scores, valid, max_detections=max_detections,
        num_candidates=num_candidates, iou_threshold=iou_threshold,
        core=nms_core_plain)
    boxes, kp = remove_letterbox(boxes, kp, padding)
    return boxes, kp, scores, valid


def detection_postprocess(raw_boxes, raw_scores, anchors, input_size,
                          padding, *, max_detections: int,
                          num_candidates: Optional[int] = None,
                          iou_threshold: float = NMS_IOU):
    """:func:`detection_postprocess_plain` for CPU tensors; for CUDA
    tensors one launch of the kernel for the whole batch, with the slab in
    one allocation.  ``detection_postprocess.launches`` counts launches."""
    dev = raw_boxes.device
    if dev.type == "cpu":
        return detection_postprocess_plain(
            raw_boxes, raw_scores, anchors, input_size, padding,
            max_detections=max_detections, num_candidates=num_candidates,
            iou_threshold=iou_threshold)
    if dev.type != "cuda":
        raise ValueError(f"detection_postprocess: unsupported device {dev}")
    if raw_boxes.dim() != 3 or raw_boxes.shape[2] != 16:
        raise ValueError(f"detection_postprocess: raw_boxes must be "
                         f"[B, A, 16], got {tuple(raw_boxes.shape)}")
    b, a = raw_boxes.shape[0], raw_boxes.shape[1]
    if raw_scores.numel() != b * a or raw_scores.shape[0] != b or \
            tuple(anchors.shape) != (a, 2):
        raise ValueError("detection_postprocess: raw_scores must be [B, A] "
                         "or [B, A, 1] and anchors [A, 2]")
    if not (raw_boxes.dtype == raw_scores.dtype == anchors.dtype
            == torch.float32):
        raise TypeError("detection_postprocess: inputs must be float32")
    if not (raw_boxes.is_contiguous() and raw_scores.is_contiguous()
            and anchors.is_contiguous()):
        raise ValueError("detection_postprocess: inputs must be contiguous")
    if raw_boxes.data_ptr() % 16 or anchors.data_ptr() % 8:
        raise ValueError("detection_postprocess: raw_boxes must be 16-byte "
                         "and anchors 8-byte aligned")
    if not (raw_scores.device == anchors.device == dev):
        raise ValueError("detection_postprocess: inputs on different "
                         "devices")
    if a > MAX_ANCHORS:
        raise ValueError(f"detection_postprocess: A = {a} exceeds the "
                         f"kernel's {MAX_ANCHORS}")
    d = int(max_detections)
    k = a if num_candidates is None else min(int(num_candidates), a)
    if d < 0 or k < 0:
        raise ValueError("detection_postprocess: max_detections and "
                         "num_candidates must be >= 0")
    pt, pb, pl, pr = padding
    # One allocation: boxes, keypoints and scores (float32), then valid.
    rows = b * d
    out = torch.empty(rows * 68 + (rows + 3) // 4 * 4, dtype=torch.bool,
                      device=dev)
    values = out.view(torch.float32)
    boxes = values.as_strided((b, d, 4), (d * 4, 4, 1))
    kp = values.as_strided((b, d, 6, 2), (d * 12, 12, 2, 1), rows * 4)
    scores = values.as_strided((b, d), (d, 1), rows * 16)
    valid = out.as_strided((b, d), (d, 1), rows * 68)
    if rows:
        rc = _build.load().fdt_detection_postprocess(
            raw_boxes.data_ptr(), raw_scores.data_ptr(), anchors.data_ptr(),
            out.data_ptr(), b, a, d, k, float(input_size), pl, pt,
            1.0 - (pl + pr), 1.0 - (pt + pb), float(iou_threshold),
            dev.index, _build.stream(dev.index))
        _build.check(rc, "detection_postprocess")
        _build.count_launch(detection_postprocess)
    return boxes, kp, scores, valid


detection_postprocess.launches = 0
