"""face_detection_tflite_torch — the PyTorch/CUDA port of the face pipeline.

A second package beside ``face_detection_tflite_tpu`` (the JAX reference),
built slice by slice.  This slice runs the STANDARD mode (BlazeFace back
detection plus the 468-point mesh) of :class:`FaceDetector` on an NVIDIA
Hopper GPU, with hand-written CUDA kernels for the weighted-NMS core and
the ROI warp.  It imports ``torch`` and numpy, never ``jax`` or the JAX
package.

Quick start::

    from face_detection_tflite_torch import FaceDetector
    det = FaceDetector()                      # CUDA; device="cpu" for the CPU
    faces = det.detect_faces_batch(frames)    # [B, H, W, 3] uint8
"""

from .convert.executor import (ConvertedModel, convert_file, convert_model,
                               params_from_jax)
from .convert.tflite import parse_tflite
from .ops.letterbox import LetterboxParams, letterbox_params
from .pipeline.config import (MODEL_FILES, FaceDetectionMode,
                              FaceDetectionModel)
from .pipeline.detector import FaceDetector, resolve_model_dir
from .pipeline.programs import PipelineModels, build_pipeline_program
from .pipeline.timings import DetectTimings, FpsCounter
from .pipeline.types import (BLENDSHAPE_NAMES, Detection, Face, FaceMesh,
                             RectF)

__version__ = "0.1.0"

__all__ = [
    "FaceDetector", "FaceDetectionMode", "FaceDetectionModel", "Face",
    "Detection", "FaceMesh", "RectF", "PipelineModels",
    "build_pipeline_program", "ConvertedModel", "convert_file",
    "convert_model", "params_from_jax", "parse_tflite", "resolve_model_dir",
    "DetectTimings", "FpsCounter", "LetterboxParams", "letterbox_params",
    "MODEL_FILES", "BLENDSHAPE_NAMES",
]
