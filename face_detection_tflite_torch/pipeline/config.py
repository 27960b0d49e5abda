"""Pipeline constants and model-variant configuration.

Mirrors `lib/src/shared/face_model_config.dart` (thresholds, model files,
variant maps).  Thresholds are MediaPipe graph options; see the reference
file for provenance notes.  A copy of the JAX package's module.
"""

from __future__ import annotations

import dataclasses
import enum

# `face_model_config.dart:49` — MediaPipe score_clipping_thresh.
RAW_SCORE_LIMIT = 100.0
# `face_model_config.dart:53` — MediaPipe min_detection_confidence.
MIN_SCORE = 0.5
# `face_model_config.dart:62` — MediaPipe min_face_presence_confidence.
DEFAULT_MIN_FACE_PRESENCE_CONFIDENCE = 0.5
# `face_model_config.dart:73` — tracked-face retirement, in processed frames.
DEFAULT_MAX_MISSED_FRAMES = 3
# `face_model_config.dart:77` — MediaPipe min_suppression_threshold.
MIN_SUPPRESSION_THRESHOLD = 0.3

MODEL_FILES = {
    "back": "face_detection_back.tflite",
    "front": "face_detection_front.tflite",
    "short_range": "face_detection_short_range.tflite",
    "full": "face_detection_full_range.tflite",
    "full_sparse": "face_detection_full_range_sparse.tflite",
    "face_landmark": "face_landmark.tflite",
    "iris_landmark": "iris_landmark.tflite",
    "face_blendshapes": "face_blendshapes.tflite",
    "embedding": "mobilefacenet.tflite",
    "segmenter_general": "selfie_segmenter.tflite",
    "segmenter_landscape": "selfie_segmenter_landscape.tflite",
    "segmenter_multiclass": "selfie_multiclass.tflite",
}


class FaceDetectionModel(enum.Enum):
    """Detector variant (`face_types.dart` FaceDetectionModel)."""

    FRONT_CAMERA = "front"
    BACK_CAMERA = "back"
    SHORT_RANGE = "short_range"
    FULL = "full"
    FULL_SPARSE = "full_sparse"


class FaceDetectionMode(enum.Enum):
    """Pipeline depth (`face_types.dart` FaceDetectionMode).

    FAST: detector only (boxes + 6 keypoints).
    STANDARD: + 468-pt mesh and presence score.
    FULL: + iris refinement, blendshapes, head pose.
    """

    FAST = "fast"
    STANDARD = "standard"
    FULL = "full"


class SegmentationModel(enum.Enum):
    GENERAL = "general"
    LANDSCAPE = "landscape"
    MULTICLASS = "multiclass"


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Segmentation configuration with presets (`face_types.dart:236-279`).

    - ``model``: which segmentation network.
    - ``max_output_size``: cap on the longer side of upsampled masks, the
      default ``max_size`` of ``SegmentationMask.upsample``.
    - ``precision``: the segmenter's convolution precision, a tier of the
      executor ("highest" = fp32, "high" = bf16x3 on the TPU and fp32 on
      the card, "default" = bf16 operands, "mixed" or a per-op callable).
    - ``mask_dtype``: the device-to-host mask encoding, "float32" (exact)
      or "uint8" (1/255 steps, a quarter of the bytes).
    - ``validate_model``: check the loaded network's output channels
      (`selfie_segmentation.dart:424-442`).

    Presets mirror the reference's names: ``safe`` (exact numerics,
    smaller outputs), ``performance`` (the defaults), ``fast`` (uint8 mask
    readback).
    """

    model: "SegmentationModel" = SegmentationModel.GENERAL
    max_output_size: int = 2048
    precision: str = "high"
    mask_dtype: str = "float32"
    validate_model: bool = True

    def __post_init__(self):
        if self.mask_dtype not in ("float32", "uint8"):
            raise ValueError(
                f"mask_dtype must be 'float32' or 'uint8', "
                f"got {self.mask_dtype!r}")
        if self.max_output_size <= 0:
            raise ValueError("max_output_size must be positive")

    @classmethod
    def safe(cls) -> "SegmentationConfig":
        """Exact numerics, smaller upsample cap (`face_types.dart:262`)."""
        return cls(precision="highest", max_output_size=1024)

    @classmethod
    def performance(cls) -> "SegmentationConfig":
        """The defaults (`face_types.dart:268`)."""
        return cls()

    @classmethod
    def fast(cls) -> "SegmentationConfig":
        """uint8 mask readback: a quarter of the device-to-host bytes
        (`face_types.dart:274`)."""
        return cls(mask_dtype="uint8")


# Model input resolutions (from the tflite graphs).
DETECTOR_INPUT_SIZE = {
    FaceDetectionModel.FRONT_CAMERA: 128,
    FaceDetectionModel.BACK_CAMERA: 256,
    FaceDetectionModel.SHORT_RANGE: 128,
    FaceDetectionModel.FULL: 192,
    FaceDetectionModel.FULL_SPARSE: 192,
}
MESH_INPUT_SIZE = 192
IRIS_INPUT_SIZE = 64
EMBEDDING_INPUT_SIZE = 112
EMBEDDING_DIM = 192

# Iris stream layout: 71 eye-contour + 5 iris points per eye, left block
# first (`face_detector.dart:1890-1893`).
IRIS_POINTS_PER_EYE = 76
LEFT_IRIS_START, LEFT_IRIS_END = 71, 76
RIGHT_IRIS_START, RIGHT_IRIS_END = 147, 152
