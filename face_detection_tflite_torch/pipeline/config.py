"""Pipeline constants and model-variant configuration.

Mirrors `lib/src/shared/face_model_config.dart` (thresholds, model files,
variant maps).  Thresholds are MediaPipe graph options; see the reference
file for provenance notes.  A copy of the JAX package's module without
the segmentation settings, which this package does not run yet.
"""

from __future__ import annotations

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
