"""The pipeline programs: FAST, STANDARD and FULL over a fixed-size face
slab.

Port of the JAX package's ``pipeline/programs.py``.  Each program is a
plain function over an image batch ``[B, H, W, 3]``:

    letterbox -> BlazeFace -> detection postprocess (K1)       (all modes)
    -> alignment -> ROI warp + normalize (K2, 192 px) -> FaceMesh
                                                     (standard and full)
    -> eye ROIs -> K2 at 64 px, right eyes mirrored -> iris net
    -> blendshape packing -> blendshape MLP-Mixer -> head pose
    -> iris-refined keypoints                                   (full)
    -> eye alignment -> K2 at 112 px -> MobileFaceNet -> L2
                                          (full, ``with_embeddings``)

Dynamic face counts are fixed-size slabs with validity masks.  Batch
dimensions are written out: the detector runs once on ``[B, S, S, 3]``
(S = 256 for BACK_CAMERA, 128 for FRONT_CAMERA and SHORT_RANGE, 192 for
FULL and FULL_SPARSE),
the mesh net once on ``[B * slab, 192, 192, 3]``, the iris net once on
``[B * 2 * slab, 64, 64, 3]``, the blendshape net once on
``[B * slab, 146, 2]`` and MobileFaceNet once on
``[B * slab, 112, 112, 3]``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..convert.executor import (ConvertedModel, fp32_on_the_card,
                                resolve_device)
from ..models.embedding import alignment_from_eyes, embed_rois
from ..ops.anchors import anchor_options_for, generate_anchors
from ..ops.detections import _take, detection_postprocess
from ..ops.letterbox import letterbox_image, letterbox_params
from ..ops.warp import extract_rois_normalized
from . import geometry
from .blendshape_input import pack_blendshape_input
from .config import (IRIS_INPUT_SIZE, MESH_INPUT_SIZE, RAW_SCORE_LIMIT,
                     FaceDetectionMode)
from .gates import apply_detection_gates_mask

__all__ = ["PipelineModels", "build_pipeline_program", "resolve_device"]


class PipelineModels:
    """The converted networks of one detector, placed on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``).  ``variant`` is
    the detector's ``FaceDetectionModel`` value; ``segmentation`` an
    optional selfie segmenter, which ``FaceDetector`` takes in place of
    loading its ``.tflite`` file."""

    def __init__(self, detector: ConvertedModel, variant: str,
                 mesh: Optional[ConvertedModel] = None,
                 device: torch.device | str | None = None, *,
                 iris: Optional[ConvertedModel] = None,
                 blendshapes: Optional[ConvertedModel] = None,
                 embedding: Optional[torch.nn.Module] = None,
                 segmentation: Optional[ConvertedModel] = None):
        self.device = resolve_device(device)
        fp32_on_the_card(self.device)
        self.detector = detector.to(self.device).eval()
        self.variant = variant
        (self.mesh, self.iris, self.blendshapes, self.embedding,
         self.segmentation) = (
            m.to(self.device).eval() if m is not None else None
            for m in (mesh, iris, blendshapes, embedding, segmentation))
        self.detector_input_size = detector.input_shapes[0][1]
        self.anchors = torch.from_numpy(detector_anchors(
            detector, variant)).to(self.device)


def detector_anchors(detector: ConvertedModel, variant: str):
    """The anchors of ``variant`` ([A, 2]); raises ValueError where the
    detector graph's box output has another anchor count."""
    anchors = generate_anchors(anchor_options_for(variant))
    boxes = max(int(np.prod(s)) for s in detector.output_shapes) // 16
    if boxes != anchors.shape[0]:
        raise ValueError(f"the detector emits {boxes} anchors; variant "
                         f"{variant!r} has {anchors.shape[0]}")
    return anchors


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


def _unpack_landmarks(flat, in_size: int, *, clamp: bool,
                      normalize_z: bool):
    """`helpers.dart:138-172` with zero padding (crops are warped straight
    to the model input): x and y over ``in_size``, clamped to [0, 1] with
    ``clamp``; z over ``in_size`` with ``normalize_z``.  The mesh stage
    takes both, the iris stage neither."""
    pts = flat.reshape(*flat.shape[:-1], flat.shape[-1] // 3, 3)
    x = pts[..., 0] / in_size
    y = pts[..., 1] / in_size
    z = pts[..., 2] / in_size if normalize_z else pts[..., 2]
    if clamp:
        x = torch.clamp(x, 0.0, 1.0)
        y = torch.clamp(y, 0.0, 1.0)
    return torch.stack([x, y, z], dim=-1)


def _sigmoid_clipped(x):
    return torch.sigmoid(torch.clamp(x, -RAW_SCORE_LIMIT, RAW_SCORE_LIMIT))


def build_pipeline_program(models: PipelineModels, img_h: int, img_w: int,
                           mode: FaceDetectionMode = FaceDetectionMode.FULL,
                           *, max_faces: int = 16,
                           num_candidates: Optional[int] = None,
                           min_score: float = 0.0, min_face_size: float = 0.0,
                           from_detections: bool = False,
                           face_slab: Optional[int] = None,
                           with_embeddings: bool = False):
    """Builds the pipeline function for one image size.

    Returns ``fn(images) -> dict`` of ``[B, ...]`` tensors for ``images``
    ``[B, img_h, img_w, 3]`` (uint8 or float 0..255, RGB, on the models'
    device).  The slab holds boxes ``[D, 4]``, raw_keypoints ``[D, 6, 2]``,
    scores ``[D]`` and valid ``[D]``; STANDARD and FULL add mesh
    ``[D, 468, 3]`` (absolute px) and mesh_scores ``[D]``; FULL adds
    keypoints ``[D, 6, 2]`` (iris-refined eyes), iris ``[D, 152, 3]``,
    blendshapes ``[D, 52]``, blendshapes_valid ``[D]`` and head_angles
    ``[D, 3]`` (pitch, yaw, roll in degrees; NaN for a degenerate head
    frame); FULL ``with_embeddings`` adds embeddings ``[D, 192]``
    (MobileFaceNet on the crops aligned on the iris-refined eyes, L2
    normalised).

    ``face_slab`` < max_faces is the speculative form: NMS still emits the
    full max_faces slab (returned compacted as det_boxes,
    det_raw_keypoints, det_scores, det_valid, with the per-image count
    det_count), but the mesh stage runs on the top ``face_slab`` prefix
    only.  ``from_detections`` returns ``fn(images, boxes, kp, scores,
    valid)`` that runs the face stages on given detections.
    """
    size = models.detector_input_size
    lbp = letterbox_params(img_h, img_w, size, size)
    compute_mesh = mode in (FaceDetectionMode.STANDARD,
                            FaceDetectionMode.FULL)
    compute_iris = mode == FaceDetectionMode.FULL
    if compute_mesh and models.mesh is None:
        raise ValueError(f"mode {mode} requires the face mesh model")
    if compute_iris and (models.iris is None or models.blendshapes is None):
        raise ValueError(f"mode {mode} requires iris and blendshape models")
    if with_embeddings and not compute_iris:
        raise ValueError("with_embeddings requires FULL mode (embeddings "
                         "align from iris-refined eye centers, "
                         "face_detector_core.dart:419-451)")
    if with_embeddings and models.embedding is None:
        raise ValueError("with_embeddings requires the embedding model")

    def detect_stage(images):
        x = letterbox_image(images, lbp)
        raw_boxes, raw_scores = _identify_detector_outputs(models.detector(x))
        # decode -> weighted NMS -> letterbox removal: one kernel launch.
        boxes, kp, scores, valid = detection_postprocess(
            raw_boxes, raw_scores, models.anchors, float(size), lbp.padding,
            max_detections=max_faces, num_candidates=num_candidates)
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
                                    MESH_INPUT_SIZE, clamp=True,
                                    normalize_z=True)
        mesh_abs = geometry.transform_mesh_to_absolute(lm_norm, cx, cy, fsize,
                                                       theta)
        return mesh_abs, _sigmoid_clipped(score_raw.reshape(b, f)), valid

    def iris_stage(images, mesh_abs):
        """[B, F, 152, 3] absolute iris stream: two eye crops per face,
        the right eye mirrored, warped with the un-negated eye angle
        (face_detector_core.dart:544-556)."""
        b, f = mesh_abs.shape[:2]
        ecx, ecy, esize, etheta = (t.reshape(b, 2 * f) for t in
                                   geometry.eye_rois_from_mesh(mesh_abs))
        # Odd slots are right eyes; made on the device (no host copy).
        flip = (torch.arange(2 * f, device=mesh_abs.device) % 2 == 1
                ).expand(b, 2 * f)
        crops = extract_rois_normalized(images, ecx, ecy, esize, etheta,
                                        out_size=IRIS_INPUT_SIZE, flip=flip)
        outs = models.iris(crops.reshape(b * 2 * f, IRIS_INPUT_SIZE,
                                         IRIS_INPUT_SIZE, 3))
        # All outputs in graph order: 71 * 3 contour, then 5 * 3 iris.
        pts_flat = torch.cat([o.reshape(b * 2 * f, -1) for o in outs], 1)
        pts = _unpack_landmarks(pts_flat.reshape(b, 2 * f, -1),
                                IRIS_INPUT_SIZE, clamp=False,
                                normalize_z=False)     # [B, 2F, 76, 3]
        abs_pts = geometry.transform_iris_norm_to_absolute(
            pts, ecx, ecy, esize, etheta, flip[..., None])
        return abs_pts.reshape(b, f, 152, 3)

    def blendshape_stage(mesh_abs, iris_abs):
        """([B, F, 52] coefficients, [B, F] no-NaN flags): NaN-sanitized
        and clamped to [0, 1] (face_blendshapes.dart:191-200)."""
        b, f = mesh_abs.shape[:2]
        packed = pack_blendshape_input(mesh_abs, iris_abs)  # [B, F, 146, 2]
        (raw,) = models.blendshapes(packed.reshape(b * f, 146, 2))
        raw = raw.reshape(b, f, -1)
        ok = ~torch.isnan(raw).any(dim=-1)
        return torch.clamp(torch.nan_to_num(raw), 0.0, 1.0), ok

    def refine_keypoints(kp, iris_abs):
        """Iris-refined eye keypoints (face_detector_core.dart:356-373)."""
        left = geometry.iris_center_from_points(iris_abs[..., 71:76, :])
        right = geometry.iris_center_from_points(iris_abs[..., 147:152, :])
        kp = kp.clone()
        kp[..., 0, 0] = left[..., 0] / img_w
        kp[..., 0, 1] = left[..., 1] / img_h
        kp[..., 1, 0] = right[..., 0] / img_w
        kp[..., 1, 1] = right[..., 1] / img_h
        return kp

    def embedding_stage(images, refined_kp):
        """[B, F, 192] embeddings, aligned (`face_embedding.dart:362-384`)
        on the iris-refined eye centres, as the reference's
        getFaceEmbedding does (face_detector.dart:703-711): K2 at 112 px
        on all [B, F] ROIs in one launch, then MobileFaceNet once
        (:func:`embed_rois`, shared with ``FaceEmbedding``)."""
        cx, cy, esize, theta = alignment_from_eyes(
            refined_kp[..., 0, 0] * img_w, refined_kp[..., 0, 1] * img_h,
            refined_kp[..., 1, 0] * img_w, refined_kp[..., 1, 1] * img_h)
        return embed_rois(models.embedding, images, cx, cy, esize, theta)

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
        if not compute_iris:
            return out
        iris_abs = iris_stage(images, mesh_abs)
        coeffs, bs_ok = blendshape_stage(mesh_abs, iris_abs)
        out.update(iris=iris_abs, blendshapes=coeffs,
                   blendshapes_valid=bs_ok & valid,
                   head_angles=geometry.head_euler_angles_from_mesh(mesh_abs),
                   keypoints=refine_keypoints(kp, iris_abs))
        if with_embeddings:
            out["embeddings"] = embedding_stage(images, out["keypoints"])
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
