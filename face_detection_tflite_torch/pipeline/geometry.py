"""Face geometry on tensors: ROI alignment and mesh back-projection.

Port of the part of the JAX package's ``pipeline/geometry.py`` that the
STANDARD path uses (semantics of `lib/src/shared/face_geometry.dart`).
Functions broadcast over any leading batch shape.
"""

from __future__ import annotations

import torch

__all__ = ["compute_face_alignment", "transform_mesh_to_absolute",
           "MESH_LEFT_EYE_CORNERS", "MESH_RIGHT_EYE_CORNERS",
           "MESH_FOREHEAD_TOP", "MESH_CHIN_BOTTOM", "MESH_LEFT_CHEEK",
           "MESH_RIGHT_CHEEK"]

# Canonical mesh indices (`face_geometry.dart:155-168, 170-180`).
MESH_LEFT_EYE_CORNERS = (33, 133)
MESH_RIGHT_EYE_CORNERS = (362, 263)
MESH_FOREHEAD_TOP = 10
MESH_CHIN_BOTTOM = 152
MESH_LEFT_CHEEK = 234
MESH_RIGHT_CHEEK = 454


def compute_face_alignment(keypoints_xy: torch.Tensor, img_w: float,
                           img_h: float):
    """ROI (theta, cx, cy, size) from detector eye/mouth keypoints.

    `face_geometry.dart:17-45`: theta = atan2 of the eye vector; size =
    max(3.6*mouthDist, 4.0*eyeDist); center = eyeMid + 0.1*mouthVec.
    ``keypoints_xy [..., 6, 2]`` are normalized; cx/cy/size come back in
    pixels.
    """
    lx = keypoints_xy[..., 0, 0] * img_w
    ly = keypoints_xy[..., 0, 1] * img_h
    rx = keypoints_xy[..., 1, 0] * img_w
    ry = keypoints_xy[..., 1, 1] * img_h
    mx = keypoints_xy[..., 3, 0] * img_w
    my = keypoints_xy[..., 3, 1] * img_h

    eye_cx = (lx + rx) * 0.5
    eye_cy = (ly + ry) * 0.5
    vex = rx - lx
    vey = ry - ly
    vmx = mx - eye_cx
    vmy = my - eye_cy

    theta = torch.atan2(vey, vex)
    eye_dist = torch.sqrt(vex * vex + vey * vey)
    mouth_dist = torch.sqrt(vmx * vmx + vmy * vmy)
    size = torch.maximum(mouth_dist * 3.6, eye_dist * 4.0)
    cx = eye_cx + vmx * 0.1
    cy = eye_cy + vmy * 0.1
    return theta, cx, cy, size


def transform_mesh_to_absolute(lm_norm: torch.Tensor, cx, cy, size, theta):
    """Normalized crop-space mesh ``[..., N, 3]`` -> absolute pixels.

    `face_geometry.dart:48-73`: abs = c + size * R(theta) @ (p - 0.5),
    z_out = z * size.
    """
    ct = torch.cos(theta)[..., None]
    st = torch.sin(theta)[..., None]
    px = lm_norm[..., 0] - 0.5
    py = lm_norm[..., 1] - 0.5
    s = size[..., None]
    x = cx[..., None] + s * (ct * px - st * py)
    y = cy[..., None] + s * (st * px + ct * py)
    z = lm_norm[..., 2] * s
    return torch.stack([x, y, z], dim=-1)
