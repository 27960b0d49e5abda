"""Blendshape V2 input packing as constant gather indices.

Port of the JAX package's ``pipeline/blendshape_input.py`` (semantics of
`lib/src/shared/blendshape_input.dart`): the model consumes 146 landmarks
(x, y in absolute image pixels) selected from the virtual 478-point layout
(468 mesh + 10 iris).  The tables are numpy copies; the packing is one
batched gather and a select.

Routing:

* slots 0..467 come from the mesh, except the 15-point eyelid rings of
  each eye, which come from the iris model's refined eye contour
  (`kBlendshapeEyeRefineOffsets`, blendshape_input.dart:222-229);
* slots 468..472 = image-left iris points (iris stream offsets 71..75);
* slots 473..477 = image-right iris points (offsets 147..151).

The iris stream is [152, 3]: 76 points per eye (71 contour + 5 iris), left
eye first (`face_detector.dart:1890-1893`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["BLENDSHAPE_LANDMARK_SUBSET", "BLENDSHAPE_NAMES",
           "EYE_REFINE_OFFSETS",
           "pack_indices", "pack_blendshape_input"]

# Blendshape V2 output order (`blendshape_input.dart:296-354`, MediaPipe
# face_blendshapes_graph.cc): the 52 coefficient names, tensor order.
BLENDSHAPE_NAMES = [
    "_neutral", "browDownLeft", "browDownRight", "browInnerUp",
    "browOuterUpLeft", "browOuterUpRight", "cheekPuff", "cheekSquintLeft",
    "cheekSquintRight", "eyeBlinkLeft", "eyeBlinkRight", "eyeLookDownLeft",
    "eyeLookDownRight", "eyeLookInLeft", "eyeLookInRight", "eyeLookOutLeft",
    "eyeLookOutRight", "eyeLookUpLeft", "eyeLookUpRight", "eyeSquintLeft",
    "eyeSquintRight", "eyeWideLeft", "eyeWideRight", "jawForward", "jawLeft",
    "jawOpen", "jawRight", "mouthClose", "mouthDimpleLeft",
    "mouthDimpleRight", "mouthFrownLeft", "mouthFrownRight", "mouthFunnel",
    "mouthLeft", "mouthLowerDownLeft", "mouthLowerDownRight",
    "mouthPressLeft", "mouthPressRight", "mouthPucker", "mouthRight",
    "mouthRollLower", "mouthRollUpper", "mouthShrugLower", "mouthShrugUpper",
    "mouthSmileLeft", "mouthSmileRight", "mouthStretchLeft",
    "mouthStretchRight", "mouthUpperUpLeft", "mouthUpperUpRight",
    "noseSneerLeft", "noseSneerRight",
]

# kBlendshapeLandmarkSubset (blendshape_input.dart:39-177), verbatim from
# MediaPipe face_blendshapes_graph.cc kLandmarksSubsetIdxs.
BLENDSHAPE_LANDMARK_SUBSET = np.asarray([
    0, 1, 4, 5, 6, 7, 8, 10, 13, 14, 17, 21, 33, 37, 39, 40, 46, 52, 53, 54,
    55, 58, 61, 63, 65, 66, 67, 70, 78, 80, 81, 82, 84, 87, 88, 91, 93, 95,
    103, 105, 107, 109, 127, 132, 133, 136, 144, 145, 146, 148, 149, 150,
    152, 153, 154, 155, 157, 158, 159, 160, 161, 162, 163, 168, 172, 173,
    176, 178, 181, 185, 191, 195, 197, 234, 246, 249, 251, 263, 267, 269,
    270, 276, 282, 283, 284, 285, 288, 291, 293, 295, 296, 297, 300, 308,
    310, 311, 312, 314, 317, 318, 321, 323, 324, 332, 334, 336, 338, 356,
    361, 362, 365, 373, 374, 375, 377, 378, 379, 380, 381, 382, 384, 385,
    386, 387, 388, 389, 390, 397, 398, 400, 402, 405, 409, 415, 454, 466,
    468, 469, 470, 471, 472, 473, 474, 475, 476, 477,
], dtype=np.int32)

# kBlendshapeEyeRefineOffsets (blendshape_input.dart:222-229):
# mesh index -> iris-stream offset of the refined eyelid-ring point.
EYE_REFINE_OFFSETS = {
    # image-left eye (mesh corners 33/133) <- irisPoints[0..14]
    33: 0, 7: 1, 163: 2, 144: 3, 145: 4, 153: 5, 154: 6, 155: 7, 133: 8,
    246: 9, 161: 10, 160: 11, 159: 12, 158: 13, 157: 14,
    # image-right eye (mesh corners 362/263) <- irisPoints[76..90]
    263: 76, 249: 77, 390: 78, 373: 79, 374: 80, 380: 81, 381: 82, 382: 83,
    362: 84, 466: 85, 388: 86, 387: 87, 386: 88, 385: 89, 384: 90,
}

IRIS_SLOT_START = 468
LEFT_EYE_IRIS_OFFSET = 71    # 478-slots 468..472
RIGHT_EYE_IRIS_OFFSET = 147  # 478-slots 473..477
IRIS_STREAM_POINTS = 152


def pack_indices() -> tuple[np.ndarray, np.ndarray]:
    """Constant routing arrays for the 146-landmark gather: ``source[i]``
    is 0 (mesh) or 1 (iris), ``index[i]`` the row in the mesh [468, 3] or
    iris [152, 3] array."""
    source = np.zeros(146, np.int32)
    index = np.zeros(146, np.int32)
    for i, slot in enumerate(BLENDSHAPE_LANDMARK_SUBSET):
        slot = int(slot)
        if slot < IRIS_SLOT_START:
            refined = EYE_REFINE_OFFSETS.get(slot)
            source[i], index[i] = (1, refined) if refined is not None \
                else (0, slot)
        elif slot - IRIS_SLOT_START < 5:
            source[i] = 1
            index[i] = LEFT_EYE_IRIS_OFFSET + slot - IRIS_SLOT_START
        else:
            source[i] = 1
            index[i] = RIGHT_EYE_IRIS_OFFSET + slot - IRIS_SLOT_START - 5
    return source, index


_SOURCE, _INDEX = pack_indices()
# The iris gather clips the mesh-slot indices (<468) into the 152-row
# iris array, as ``jnp.take(mode="clip")`` does; those lanes are masked
# out by the select, so one index table serves both gathers.
_IRIS_INDEX = np.minimum(_INDEX, IRIS_STREAM_POINTS - 1)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(mesh rows, iris rows, iris-source mask) on ``device``, uploaded
    once per device and never evicted: a captured program
    (``pipeline/graphs.py``) reads them at every replay."""
    return (torch.from_numpy(_INDEX).long().to(device),
            torch.from_numpy(_IRIS_INDEX).long().to(device),
            torch.from_numpy(_SOURCE.astype(bool))[:, None].to(device))


def pack_blendshape_input(mesh_abs: torch.Tensor,
                          iris_abs: torch.Tensor) -> torch.Tensor:
    """``mesh_abs [..., 468, 3]`` and ``iris_abs [..., 152, 3]`` (absolute
    pixels) -> ``[..., 146, 2]`` (x, y), the blendshape model's input."""
    mesh_rows, iris_rows, from_iris = _tables(mesh_abs.device)
    return torch.where(from_iris, iris_abs[..., iris_rows, :2],
                       mesh_abs[..., mesh_rows, :2])
