"""The pipeline programs: FAST and STANDARD over a fixed-size face slab.

Port of the JAX package's ``pipeline/programs.py``.  Each program is a
plain function over an image batch ``[B, H, W, 3]``:

    letterbox -> BlazeFace -> decode -> weighted NMS (K1)      (all modes)
    -> alignment -> ROI warp + normalize (K2) -> FaceMesh      (standard)

Dynamic face counts are fixed-size slabs with validity masks.  Batch
dimensions are written out: the detector runs once on ``[B, 256, 256, 3]``
and the mesh net once on ``[B * slab, 192, 192, 3]``.  FULL mode (iris,
blendshapes, head pose) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..convert.executor import ConvertedModel
from ..ops.anchors import anchor_options_for, generate_anchors
from ..ops.detections import (_take, decode_detections, remove_letterbox,
                              weighted_nms)
from ..ops.letterbox import letterbox_image, letterbox_params
from ..ops.warp import extract_rois_normalized
from . import geometry
from .config import MESH_INPUT_SIZE, RAW_SCORE_LIMIT, FaceDetectionMode
from .gates import apply_detection_gates_mask

__all__ = ["PipelineModels", "build_pipeline_program", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as given (``cuda`` resolved to ``cuda:N``), else
    ``cuda``; raises when CUDA is absent and the caller did not ask for
    the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.empty(0, device=device).device


class PipelineModels:
    """The converted networks of one detector, placed on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, detector: ConvertedModel, variant: str,
                 mesh: Optional[ConvertedModel] = None,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.detector = detector.to(self.device).eval()
        self.variant = variant
        self.mesh = mesh.to(self.device).eval() if mesh is not None else None
        self.detector_input_size = detector.input_shapes[0][1]
        self.anchors = torch.from_numpy(
            generate_anchors(anchor_options_for(variant))).to(self.device)


def _identify_detector_outputs(outs):
    """(raw_boxes [B, A, 16], raw_scores [B, A]) whatever the graph's
    output order (`face_detection_model.dart:198-267`)."""
    a, b = outs
    n = a.shape[0]
    boxes, scores = (a, b) if a[0].numel() > b[0].numel() else (b, a)
    return boxes.reshape(n, -1, 16), scores.reshape(n, -1)


def _identify_landmark_outputs(outs):
    """(landmarks [N, 1404], presence logit [N] or None): the largest
    output of a multiple of 3 values per sample is the mesh, the
    one-value output is the presence (`face_landmark.dart:154-167`)."""
    flat = [o.reshape(o.shape[0], -1) for o in outs]
    lm = max((o for o in flat if o.shape[1] % 3 == 0),
             key=lambda o: o.shape[1])
    score = next((o[:, 0] for o in flat if o.shape[1] == 1), None)
    return lm, score


def _unpack_landmarks(flat, in_size: int):
    """`helpers.dart:138-172` with zero padding, x/y clamped to [0, 1] and
    z normalized (the mesh-stage settings)."""
    pts = flat.reshape(*flat.shape[:-1], flat.shape[-1] // 3, 3)
    x = torch.clamp(pts[..., 0] / in_size, 0.0, 1.0)
    y = torch.clamp(pts[..., 1] / in_size, 0.0, 1.0)
    z = pts[..., 2] / in_size
    return torch.stack([x, y, z], dim=-1)


def _sigmoid_clipped(x):
    return torch.sigmoid(torch.clamp(x, -RAW_SCORE_LIMIT, RAW_SCORE_LIMIT))


def build_pipeline_program(models: PipelineModels, img_h: int, img_w: int,
                           mode: FaceDetectionMode = FaceDetectionMode.STANDARD,
                           *, max_faces: int = 16,
                           num_candidates: Optional[int] = None,
                           min_score: float = 0.0, min_face_size: float = 0.0,
                           from_detections: bool = False,
                           face_slab: Optional[int] = None):
    """Builds the pipeline function for one image size.

    Returns ``fn(images) -> dict`` of ``[B, ...]`` tensors for ``images``
    ``[B, img_h, img_w, 3]`` (uint8 or float 0..255, RGB, on the models'
    device).  The slab holds boxes ``[D, 4]``, raw_keypoints ``[D, 6, 2]``,
    scores ``[D]`` and valid ``[D]``; STANDARD adds mesh ``[D, 468, 3]``
    (absolute px) and mesh_scores ``[D]``.

    ``face_slab`` < max_faces is the speculative form: NMS still emits the
    full max_faces slab (returned compacted as det_boxes,
    det_raw_keypoints, det_scores, det_valid, with the per-image count
    det_count), but the mesh stage runs on the top ``face_slab`` prefix
    only.  ``from_detections`` returns ``fn(images, boxes, kp, scores,
    valid)`` that runs the face stages on given detections.
    """
    if mode == FaceDetectionMode.FULL:
        raise NotImplementedError(
            "FULL mode (iris, blendshapes, head pose) is not ported yet "
            "(ROADMAP §1 item 5)")
    size = models.detector_input_size
    lbp = letterbox_params(img_h, img_w, size, size)
    compute_mesh = mode == FaceDetectionMode.STANDARD
    if compute_mesh and models.mesh is None:
        raise ValueError(f"mode {mode} requires the face mesh model")

    def detect_stage(images):
        x = letterbox_image(images, lbp)
        raw_boxes, raw_scores = _identify_detector_outputs(models.detector(x))
        boxes, kp, scores, valid = decode_detections(
            raw_boxes, raw_scores, models.anchors, float(size))
        boxes, kp, scores, valid = weighted_nms(
            boxes, kp, scores, valid, max_detections=max_faces,
            num_candidates=num_candidates)
        boxes, kp = remove_letterbox(boxes, kp, lbp.padding)
        valid = apply_detection_gates_mask(
            valid, scores, boxes, min_score=min_score,
            min_face_size=min_face_size, image_width=float(img_w))
        return boxes, kp, scores, valid

    def mesh_stage(images, kp, valid):
        theta, cx, cy, fsize = geometry.compute_face_alignment(
            kp, float(img_w), float(img_h))
        # Degenerate-size drop (face_detector_core.dart:258-263).
        valid = valid & (torch.floor(fsize + 0.5) > 0)
        # The reference warps with the NEGATED alignment angle
        # (face_detector_core.dart:489) and maps back with +theta.
        crops = extract_rois_normalized(images, cx, cy, fsize, -theta,
                                        out_size=MESH_INPUT_SIZE)
        b, f = crops.shape[:2]
        lm_flat, score_raw = _identify_landmark_outputs(
            models.mesh(crops.reshape(b * f, MESH_INPUT_SIZE,
                                      MESH_INPUT_SIZE, 3)))
        if score_raw is None:
            score_raw = torch.zeros(b * f, device=crops.device)
        lm_norm = _unpack_landmarks(lm_flat.reshape(b, f, -1),
                                    MESH_INPUT_SIZE)
        mesh_abs = geometry.transform_mesh_to_absolute(lm_norm, cx, cy, fsize,
                                                       theta)
        return mesh_abs, _sigmoid_clipped(score_raw.reshape(b, f)), valid

    def face_stages(images, boxes, kp, scores, valid):
        out = {"boxes": boxes, "raw_keypoints": kp, "scores": scores,
               "valid": valid}
        if not compute_mesh:
            # FAST still drops degenerate alignments
            # (face_detector_core.dart:258-266).
            _, _, _, fsize = geometry.compute_face_alignment(
                kp, float(img_w), float(img_h))
            out["valid"] = valid & (torch.floor(fsize + 0.5) > 0)
            return out
        mesh_abs, mesh_scores, valid = mesh_stage(images, kp, valid)
        out.update(mesh=mesh_abs, mesh_scores=mesh_scores, valid=valid)
        return out

    if from_detections:
        return face_stages

    slab = max_faces if face_slab is None else min(face_slab, max_faces)
    if mode == FaceDetectionMode.FAST:
        slab = max_faces

    def program(images):
        boxes, kp, scores, valid = detect_stage(images)
        if slab < max_faces:
            # Compact valid detections to the front, stably, before taking
            # the speculative prefix (gates can invalidate a higher-scored
            # entry while a lower-scored one stays valid).
            order = torch.argsort((~valid).to(torch.uint8), dim=1,
                                  stable=True)
            boxes, kp, scores, valid = (_take(t, order)
                                        for t in (boxes, kp, scores, valid))
        out = face_stages(images, boxes[:, :slab], kp[:, :slab],
                          scores[:, :slab], valid[:, :slab])
        if slab < max_faces:
            out.update(det_boxes=boxes, det_raw_keypoints=kp,
                       det_scores=scores, det_valid=valid,
                       det_count=valid.sum(dim=1, dtype=torch.int32))
        return out

    return program
