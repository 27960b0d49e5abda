"""Face geometry on tensors: ROI alignment, mesh and iris back-projection,
eye ROIs, head pose and iris centers.

Port of the JAX package's ``pipeline/geometry.py`` (semantics of
`lib/src/shared/face_geometry.dart`), but for its flat-layout mesh
variant.  Functions broadcast over any leading batch shape.
"""

from __future__ import annotations

import math

import torch

__all__ = ["compute_face_alignment", "transform_mesh_to_absolute",
           "transform_iris_norm_to_absolute", "eye_rois_from_mesh",
           "head_euler_angles_from_mesh", "roll_from_eyes",
           "face_detection_to_roi", "iris_center_from_points",
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


def transform_iris_norm_to_absolute(lm_norm: torch.Tensor, cx, cy, size,
                                    theta, is_right):
    """Iris-crop landmarks ``[..., N, 3]`` -> absolute pixels, undoing the
    right-eye mirror (``is_right [..., 1]`` or broadcastable).

    `face_geometry.dart:109-125`.  The reference rotates back with
    R(theta), not R(theta)^T (which would invert the warp's sampling map);
    reproduced as it is.  z passes through untouched.
    """
    ct = torch.cos(theta)[..., None]
    st = torch.sin(theta)[..., None]
    px = torch.where(is_right, 1.0 - lm_norm[..., 0], lm_norm[..., 0]) - 0.5
    py = lm_norm[..., 1] - 0.5
    s = size[..., None]
    lx = px * s
    ly = py * s
    x = cx[..., None] + lx * ct - ly * st
    y = cy[..., None] + lx * st + ly * ct
    return torch.stack([x, y, lm_norm[..., 2]], dim=-1)


def eye_rois_from_mesh(mesh_abs: torch.Tensor):
    """Eye ROIs from mesh corners 33/133 (left) and 362/263 (right).

    `face_geometry.dart:155-168`: center = corner midpoint, size =
    2.3 * eyeDist, theta = atan2 of the corner vector.  ``mesh_abs
    [..., 468, 3]`` -> (cx, cy, size, theta), each ``[..., 2]`` with the
    eye index last (0 = image-left, 1 = image-right).
    """
    def roi(a, b):
        p0 = mesh_abs[..., a, :2]
        p1 = mesh_abs[..., b, :2]
        c = (p0 + p1) * 0.5
        d = p1 - p0
        dist = torch.sqrt(torch.sum(d * d, dim=-1))
        theta = torch.atan2(d[..., 1], d[..., 0])
        return c[..., 0], c[..., 1], dist * 2.3, theta

    left = roi(*MESH_LEFT_EYE_CORNERS)
    right = roi(*MESH_RIGHT_EYE_CORNERS)
    return tuple(torch.stack([lv, rv], dim=-1)
                 for lv, rv in zip(left, right))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def head_euler_angles_from_mesh(mesh_abs: torch.Tensor) -> torch.Tensor:
    """(pitch, yaw, roll) in degrees, ML Kit sign convention:
    ``mesh_abs [..., 468, 3]`` -> ``[..., 3]``.

    `face_geometry.dart:175-247`: an orthonormal head frame from the
    forehead, chin and cheek landmarks by Gram-Schmidt, then the aerospace
    ZYX angles with ML Kit's signs.  Degenerate frames (coincident
    landmarks, parallel axes) give NaN, the reference's null
    (face_geometry.dart:215-229).
    """
    f = mesh_abs[..., MESH_FOREHEAD_TOP, :]
    c = mesh_abs[..., MESH_CHIN_BOTTOM, :]
    l = mesh_abs[..., MESH_LEFT_CHEEK, :]
    r = mesh_abs[..., MESH_RIGHT_CHEEK, :]

    right = r - l
    down = c - f
    rlen = _norm(right)
    dlen = _norm(down)
    right = right / torch.clamp_min(rlen, 1e-12)
    down = down / torch.clamp_min(dlen, 1e-12)

    ddr = torch.sum(down * right, dim=-1, keepdim=True)
    down = down - ddr * right
    dlen2 = _norm(down)
    down = down / torch.clamp_min(dlen2, 1e-12)

    # back = right x down, z component only.
    bz = right[..., 0] * down[..., 1] - right[..., 1] * down[..., 0]

    pitch = torch.atan2(down[..., 2], bz)
    yaw = torch.asin(torch.clamp(-right[..., 2], -1.0, 1.0))
    roll = torch.atan2(right[..., 1], right[..., 0])
    deg = 180.0 / math.pi
    angles = torch.stack([-pitch * deg, -yaw * deg, -roll * deg], dim=-1)
    degenerate = ((rlen < 1e-6) | (dlen < 1e-6) | (dlen2 < 1e-6))
    return torch.where(degenerate, torch.full_like(angles, math.nan), angles)


def roll_from_eyes(left_eye_xy: torch.Tensor, right_eye_xy: torch.Tensor):
    """Fast-mode roll fallback from two eye points (`face_geometry.dart:252`)."""
    d = right_eye_xy - left_eye_xy
    return -torch.atan2(d[..., 1], d[..., 0]) * (180.0 / math.pi)


def face_detection_to_roi(box: torch.Tensor, expand_fraction: float = 0.6):
    """Expanded square ROI ``[..., 4]`` (xmin, ymin, xmax, ymax) from a
    normalized box (`face_geometry.dart:260`)."""
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    cx = (box[..., 0] + box[..., 2]) * 0.5
    cy = (box[..., 1] + box[..., 3]) * 0.5
    s = torch.maximum(w * (1.0 + expand_fraction),
                      h * (1.0 + expand_fraction)) * 0.5
    return torch.stack([cx - s, cy - s, cx + s, cy + s], dim=-1)


def iris_center_from_points(pts: torch.Tensor) -> torch.Tensor:
    """The iris point nearest the centroid of ``pts [..., K, 3]``
    (`face_types.dart:976`) -> ``[..., 3]``: an input point, the first one
    on a tie (``jnp.argmin``'s rule and ``torch.argmin``'s)."""
    centroid = torch.mean(pts[..., :2], dim=-2, keepdim=True)
    d = torch.sum((pts[..., :2] - centroid) ** 2, dim=-1)
    best = torch.argmin(d, dim=-1)
    return torch.gather(
        pts, -2, best[..., None, None].expand(*best.shape, 1, pts.shape[-1])
    ).squeeze(-2)
