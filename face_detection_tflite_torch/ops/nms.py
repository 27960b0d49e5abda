"""Weighted-NMS core: the Hopper kernel (``csrc/nms.cu``) and its plain
PyTorch version.

Replaces the JAX package's ``ops/nms_pallas.py::_nms_kernel`` and, on the
main path, the all-anchor XLA fixpoint in ``ops/detections.py::weighted_nms``
(k = 896), which compute the same function: pairwise IoU, the greedy leader
scan with a strict ``IoU > thr``, ownership of each candidate by its
lowest-index overlapping leader, and the score-weighted blend of each
leader's owned boxes.

:func:`nms_core` takes a CPU tensor to :func:`nms_core_plain` and a CUDA
tensor to the kernel (one launch for the whole batch); nothing else.
"""

from __future__ import annotations

import torch

from ..kernels import build as _build
from ..pipeline.config import MIN_SUPPRESSION_THRESHOLD

__all__ = ["nms_core", "nms_core_plain", "MAX_K"]

#: The kernel keeps 26 bytes per candidate in shared memory (227 KB max).
MAX_K = 8192


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of ``[B, k, 4]`` (xmin, ymin, xmax, ymax) boxes; row i,
    column j: ``inter / (area_i + area_j - inter)``."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    area = torch.clamp_min(x1 - x0, 0) * torch.clamp_min(y1 - y0, 0)
    ix0 = torch.maximum(x0[:, :, None], x0[:, None, :])
    iy0 = torch.maximum(y0[:, :, None], y0[:, None, :])
    ix1 = torch.minimum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.minimum(y1[:, :, None], y1[:, None, :])
    inter = torch.clamp_min(ix1 - ix0, 0) * torch.clamp_min(iy1 - iy0, 0)
    union = area[:, :, None] + area[:, None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_core_plain(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor,
                   iou_threshold: float = MIN_SUPPRESSION_THRESHOLD
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX fixpoint (``detections.py:138-194``) on a batch.

    ``boxes [B, k, 4]``, ``scores [B, k]``, ``valid [B, k]`` in descending
    score order -> (``leader [B, k]`` bool, ``blended [B, k, 4]``, zero on
    non-leader rows).
    """
    k = scores.shape[1]
    valid = valid.bool()
    iou = _iou_matrix(boxes)
    overlap = (iou > iou_threshold) & valid[:, None, :]  # strict >
    idx = torch.arange(k, device=boxes.device)
    upper = overlap & (idx[:, None] < idx[None, :])       # i suppresses j>i
    # Greedy leaders as a fixpoint: l[j] = valid[j] & !any_{i<j} l[i] & up[i,j].
    leader = valid
    for _ in range(k):
        nxt = valid & ~(leader[:, :, None] & upper).any(dim=1)
        if torch.equal(nxt, leader):
            break
        leader = nxt
    # Owner of j: the first leader whose row overlaps it (k = none).
    owner_key = torch.where(leader[:, :, None] & overlap, idx[None, :, None],
                            torch.full_like(idx, k)[None, :, None])
    owner = owner_key.min(dim=1).values                   # [B, k]
    member_w = torch.where(owner[:, None, :] == idx[None, :, None],
                           scores[:, None, :],
                           torch.zeros((), dtype=scores.dtype,
                                       device=scores.device))
    wsum = torch.clamp_min(member_w.sum(dim=2, keepdim=True), 1e-12)
    blended = torch.matmul(member_w, boxes) / wsum
    return leader, blended


def nms_core(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float = MIN_SUPPRESSION_THRESHOLD
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(leader ``[B, k]`` bool, blended ``[B, k, 4]``) for score-sorted
    candidates: the kernel for CUDA tensors, the plain version for CPU
    tensors.  ``nms_core.launches`` counts kernel launches."""
    if boxes.device.type == "cpu":
        return nms_core_plain(boxes, scores, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_core: unsupported device {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"nms_core: boxes must be [B, k, 4], got "
                         f"{tuple(boxes.shape)}")
    b, k = boxes.shape[:2]
    if tuple(scores.shape) != (b, k) or tuple(valid.shape) != (b, k):
        raise ValueError("nms_core: scores and valid must be [B, k]")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms_core: boxes and scores must be float32")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("nms_core: valid must be bool or uint8")
    if not (boxes.is_contiguous() and scores.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("nms_core: inputs must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_core: boxes must be 16-byte aligned")
    if not (scores.device == valid.device == boxes.device):
        raise ValueError("nms_core: inputs on different devices")
    if k > MAX_K:
        raise ValueError(f"nms_core: k = {k} exceeds the kernel's "
                         f"{MAX_K}")
    leader = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    blended = torch.empty((b, k, 4), dtype=torch.float32,
                          device=boxes.device)
    if b and k:
        lib = _build.load()
        rc = lib.fdt_nms_core(
            boxes.data_ptr(), scores.data_ptr(),
            valid.view(torch.uint8).data_ptr(),
            leader.view(torch.uint8).data_ptr(),
            blended.data_ptr(), b, k, float(iou_threshold),
            boxes.device.index, _build.stream(boxes.device.index))
        _build.check(rc, "nms_core")
        _build.count_launch(nms_core)
    return leader, blended


nms_core.launches = 0
