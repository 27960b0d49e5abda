"""face_detection_tflite_torch — the PyTorch/CUDA port of the face pipeline.

A second package beside ``face_detection_tflite_tpu`` (the JAX reference),
built slice by slice.  It runs :class:`FaceDetector` on an NVIDIA Hopper
GPU in FULL mode, the default (BlazeFace back detection, the 468-point
mesh, iris landmarks, blendshapes, head pose and iris-refined keypoints,
and on request face embeddings), and in STANDARD and FAST, with
hand-written CUDA kernels for the detection postprocess and the ROI warp;
:class:`FaceEmbedding` (MobileFaceNet) embeds faces on its own;
:class:`ServingPipeline` pipelines batches and :class:`FaceServer` serves
HTTP requests in micro-batches.  It imports ``torch`` and numpy, never
``jax`` or the JAX package.

Quick start::

    from face_detection_tflite_torch import FaceDetector
    det = FaceDetector()                      # CUDA; device="cpu" for the CPU
    faces = det.detect_faces_batch(frames)    # [B, H, W, 3] uint8
"""

from .convert.checkpoint import load_params_npz, save_params_npz
from .convert.executor import (ConvertedModel, convert_file, convert_model,
                               params_from_jax)
from .models.embedding import (FaceEmbedding, UntrainedEmbeddingWarning,
                               compute_embedding_alignment, cosine_similarity,
                               euclidean_distance)
from .convert.tflite import parse_tflite
from .ops.letterbox import LetterboxParams, letterbox_params
from .pipeline.config import (MODEL_FILES, FaceDetectionMode,
                              FaceDetectionModel)
from .pipeline.detector import FaceDetector, resolve_model_dir
from .pipeline.programs import PipelineModels, build_pipeline_program
from .pipeline.server import FaceServer, ServerOverloaded
from .pipeline.serving import ServingPipeline
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
    "MODEL_FILES", "BLENDSHAPE_NAMES", "FaceEmbedding",
    "UntrainedEmbeddingWarning", "cosine_similarity", "euclidean_distance",
    "compute_embedding_alignment", "load_params_npz", "save_params_npz",
    "FaceServer", "ServerOverloaded", "ServingPipeline",
]
