"""Standalone model classes — the reference's per-model public API.

Port of the JAX package's ``models/standalone.py``.  The reference exposes
each network as an independently usable class (`FaceDetection`,
`FaceLandmark`, `IrisLandmark`, `FaceBlendshapesModel` —
`lib/src/models/*`) besides the orchestrating `FaceDetector`; each class
here owns one converted network plus its pre- and postprocessing.
:class:`FaceDetection` runs the letterbox, BlazeFace and the fused
detection postprocess (``ops/detections.py::detection_postprocess``, one
kernel launch a call on the card); the crop models run their network on a
crop that the caller supplies.  ``FaceEmbedding`` lives in
``models/embedding.py``.

Deliberate differences from the JAX classes: a keyword-only ``model=``
(a ``ConvertedModel``) may replace loading the ``.tflite`` file from
``model_dir``, and ``device=`` places the network (``cuda`` unless the
caller passes ``device="cpu"``; without CUDA and without an explicit
device the constructor raises).  :class:`FaceDetection` runs every
detector variant (its input size from the network, its anchors from the
variant); precisions other than "highest" raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..convert.executor import (ConvertedModel, convert_file,
                                fp32_on_the_card, resolve_device)
from ..ops.detections import detection_postprocess
from ..ops.letterbox import (letterbox_image, letterbox_params,
                             normalize_image)
from ..pipeline.config import (IRIS_INPUT_SIZE, MESH_INPUT_SIZE, MODEL_FILES,
                               FaceDetectionModel as Variant)
from ..pipeline.programs import (_identify_detector_outputs,
                                 _identify_landmark_outputs,
                                 _sigmoid_clipped, _unpack_landmarks,
                                 detector_anchors)
from ..pipeline.types import Detection, RectF
from ..pipeline.upload import upload
from ..utils.image import fit_max_dim, normalize_channels

__all__ = ["FaceDetection", "FaceLandmark", "IrisLandmark",
           "FaceBlendshapesModel"]


class _Disposable:
    """`dispose()` semantics shared by the standalone model classes: the
    reference frees its interpreters and makes later calls throw
    (`face_detection_model.dart:525` et al.); here dispose drops the
    network and poisons further use."""

    _disposed = False

    def dispose(self) -> None:
        self._disposed = True
        self.model = None

    def _check_disposed(self) -> None:
        if self._disposed:
            raise RuntimeError(
                f"{type(self).__name__} has been disposed")


def _load(key: str, model_dir: Optional[str], model: Optional[ConvertedModel],
          device) -> tuple[ConvertedModel, torch.device]:
    """The network (``model``, else ``MODEL_FILES[key]`` from the model
    directory) in eval mode on the resolved device, with cuDNN's TF32 off
    where that is the card."""
    device = resolve_device(device)
    if model is None:
        from ..pipeline.detector import resolve_model_dir
        model = convert_file(os.path.join(resolve_model_dir(model_dir),
                                          MODEL_FILES[key]))
    fp32_on_the_card(device)
    return model.to(device).eval(), device


def _check_precision(precision: str) -> None:
    if precision != "highest":
        raise NotImplementedError(f"precision {precision!r} is not ported "
                                  f"yet (ROADMAP §1 item 2)")


def _crop(crop, size: int, device: torch.device) -> torch.Tensor:
    """A ``[size, size, C]`` crop (numpy or tensor) as ``[1, size, size,
    C]`` float32 in [-1, 1] on ``device``."""
    if tuple(crop.shape[:2]) != (size, size):
        # A ValueError, not an assert: asserts vanish under python -O.
        raise ValueError(f"expects a {size}x{size} crop, got "
                         f"{tuple(crop.shape[:2])}")
    if not isinstance(crop, torch.Tensor):
        crop = np.asarray(crop)
    return normalize_image(upload(crop, device)[None])


class FaceDetection(_Disposable):
    """Standalone BlazeFace: image -> list[Detection].

    Equivalent of `lib/src/models/face_detection_model.dart`: the
    letterbox, the backbone, and decode, weighted NMS and letterbox
    removal in one K1 launch (``detection_postprocess``) a call on the
    card.  ``max_dim`` caps the longer input side (a host INTER_LINEAR
    downscale before detection; boxes and keypoints are normalized, so
    they keep their meaning).
    """

    def __init__(self, variant: Variant = Variant.BACK_CAMERA,
                 model_dir: Optional[str] = None, max_detections: int = 16,
                 precision: str = "highest",
                 max_dim: Optional[int] = None, *,
                 model: Optional[ConvertedModel] = None, device=None):
        _check_precision(precision)
        self.max_dim = max_dim
        self.variant = variant
        self.model, self.device = _load(variant.value, model_dir, model,
                                        device)
        self.input_size = self.model.input_shapes[0][1]
        self.anchors = torch.from_numpy(detector_anchors(
            self.model, variant.value)).to(self.device)
        self.max_detections = max_detections

    def __call__(self, image) -> list[Detection]:
        self._check_disposed()
        image = np.asarray(image)
        # The channel tolerance of every public entry point: grayscale
        # replicates, RGBA drops alpha.
        if image.ndim == 2:
            image = image[..., None]
        if image.ndim != 3 or image.shape[-1] not in (1, 3, 4):
            raise ValueError(
                f"expected [H, W, {{1,3,4}}] image, got {image.shape}")
        if self.max_dim is not None:
            image = fit_max_dim(image, self.max_dim)
        h, w = image.shape[:2]
        lbp = letterbox_params(h, w, self.input_size, self.input_size)
        with torch.inference_mode():
            x = letterbox_image(normalize_channels(image[None], self.device),
                                lbp)
            raw_boxes, raw_scores = _identify_detector_outputs(self.model(x))
            boxes, kp, scores, valid = detection_postprocess(
                raw_boxes, raw_scores, self.anchors, float(self.input_size),
                lbp.padding, max_detections=self.max_detections)
            # One packed buffer, one device-to-host copy.
            d = boxes.shape[1]
            packed = torch.cat([boxes[0], kp[0].reshape(d, 12),
                                scores[0, :, None],
                                valid[0, :, None].float()], dim=1).cpu()
        packed = packed.numpy()
        boxes, kp = packed[:, :4], packed[:, 4:16].reshape(-1, 6, 2)
        scores, valid = packed[:, 16], packed[:, 17] > 0.5
        return [Detection(RectF(*map(float, boxes[i])), float(scores[i]),
                          kp[i])
                for i in range(len(valid)) if valid[i]]


class FaceLandmark(_Disposable):
    """Standalone FaceMesh: 192x192 face crop -> (landmarks, score).

    Equivalent of `lib/src/models/face_landmark.dart`: landmarks come back
    normalized to the crop ([468, 3], x/y in [0, 1], z normalized like the
    reference); the score is the sigmoid presence confidence, or None for
    a graph without a presence output.
    """

    def __init__(self, model_dir: Optional[str] = None,
                 precision: str = "highest", *,
                 model: Optional[ConvertedModel] = None, device=None):
        _check_precision(precision)
        self.model, self.device = _load("face_landmark", model_dir, model,
                                        device)
        self.input_size = MESH_INPUT_SIZE

    def call_with_score(self, face_crop) -> tuple[np.ndarray,
                                                   Optional[float]]:
        self._check_disposed()
        with torch.inference_mode():
            x = _crop(face_crop, self.input_size, self.device)
            lm, score = _identify_landmark_outputs(self.model(x))
            lm = _unpack_landmarks(lm, self.input_size, clamp=True,
                                   normalize_z=True)[0]
            # -1 is the "no score" sentinel of a graph without one.
            s = (_sigmoid_clipped(score.reshape(1)) if score is not None
                 else torch.full((1,), -1.0, device=self.device))
            packed = torch.cat([lm.reshape(-1), s]).cpu().numpy()
        s = float(packed[-1])
        return packed[:-1].reshape(-1, 3), (s if s >= 0.0 else None)

    def __call__(self, face_crop) -> np.ndarray:
        return self.call_with_score(face_crop)[0]


class IrisLandmark(_Disposable):
    """Standalone iris model: 64x64 eye crop -> [76, 3] points.

    Equivalent of `lib/src/models/iris_landmark.dart`: 71 eye-contour
    points followed by 5 iris points, x/y normalized to the crop, z raw.
    """

    def __init__(self, model_dir: Optional[str] = None,
                 precision: str = "highest", *,
                 model: Optional[ConvertedModel] = None, device=None):
        _check_precision(precision)
        self.model, self.device = _load("iris_landmark", model_dir, model,
                                        device)
        self.input_size = IRIS_INPUT_SIZE

    def __call__(self, eye_crop) -> np.ndarray:
        self._check_disposed()
        with torch.inference_mode():
            outs = self.model(_crop(eye_crop, self.input_size, self.device))
            flat = torch.cat([o.reshape(-1) for o in outs])
            return _unpack_landmarks(flat[None], self.input_size,
                                     clamp=False, normalize_z=False
                                     )[0].cpu().numpy()


class FaceBlendshapesModel(_Disposable):
    """Standalone Blendshape V2: [146, 2] landmarks (pixels) -> 52
    coefficients.

    Equivalent of `lib/src/models/face_blendshapes.dart`, with the NaN
    check and clamp (`:191-200`) and the input-shape validation.
    """

    def __init__(self, model_dir: Optional[str] = None,
                 precision: str = "highest", *,
                 model: Optional[ConvertedModel] = None, device=None):
        _check_precision(precision)
        self.model, self.device = _load("face_blendshapes", model_dir, model,
                                        device)

    def __call__(self, landmarks_146) -> Optional[np.ndarray]:
        """[146, 2] pixels -> [52] coefficients in [0, 1], or None when the
        network emits a NaN (the reference nulls the whole result,
        face_blendshapes.dart:189-196)."""
        self._check_disposed()
        pts = np.asarray(landmarks_146, np.float32)
        if pts.shape != (146, 2):
            raise ValueError(
                f"blendshape input must be [146, 2] pixels, got {pts.shape}")
        with torch.inference_mode():
            (coeffs,) = self.model(upload(pts, self.device)[None])
            raw = coeffs.reshape(52)
            ok = ~torch.isnan(raw).any()
            packed = torch.cat([torch.clamp(torch.nan_to_num(raw), 0.0, 1.0),
                                ok.float().reshape(1)]).cpu().numpy()
        return packed[:52] if packed[52] > 0.5 else None
