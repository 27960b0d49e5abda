"""The FULL face pipeline in plain PyTorch and NumPy: the reference that
decides ``correct``.

Semantics (MediaPipe's face landmarker as the port documents it, written
out here without any of the port's code):

1. letterbox to the detector's input: cv2 INTER_LINEAR-exact separable
   resize (rows first), [-1, 1], black (-1) padding split evenly;
2. the detector; decode: ``raw / input_size + anchor``, score
   ``sigmoid(clip(logit, +-100))``, a candidate where the score is at least
   0.5 and the box has positive width and height;
3. weighted NMS over every candidate, in descending score order (stable):
   a candidate leads unless an earlier leader overlaps it with IoU > 0.3;
   each candidate belongs to the first leader that overlaps it; a
   leader's box is the score-weighted mean of its members, its score and
   keypoints its own; the first ``max_faces`` leaders, then the
   letterbox removed;
4. per face: the ROI from the eyes and the mouth (angle of the eye line;
   size ``max(3.6 * mouth distance, 4 * eye distance)``; centre
   ``eye midpoint + 0.1 * mouth vector``), a 192 px crop (size rounded
   half up, sampled bilinearly with outside taps 0, rotated by the
   negated angle), FaceMesh, landmarks back to image pixels; the face is
   dropped where the presence score is under 0.5;
5. eye ROIs from the mesh's eye corners (33/133, 362/263; 2.3 eye
   widths), 64 px crops (the right one mirrored), the iris net, points
   back to pixels (the reference's forward rotation reproduced);
6. the 146 blendshape landmarks, the MLP-Mixer, coefficients clamped to
   [0, 1]; the head pose from four mesh points; each eye keypoint
   replaced by the iris point nearest its iris points' centroid;
7. with embeddings: the 112 px crop aligned on those eye points (2.5 eye
   distances, 0.15 of that below the eye midpoint), MobileFaceNet, L2
   normalised.

Decisions that fp32 rounding can flip are recorded rather than trusted:
a frame is *ambiguous* where a candidate's logit, an IoU that decides a
suppression or an ownership, an order between interacting candidates or
a presence logit lies within rounding of its threshold; a face's later
outputs are *excluded* where a crop size lies within rounding of a
half pixel or the iris centre is a near tie.  ``operands`` is handed to
every convolution and fully-connected layer (the control's TF32
rounding).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .interp import Network
from .mobilefacenet import MobileFaceNet

MIN_SCORE = 0.5
IOU_THRESHOLD = 0.3
PRESENCE = 0.5
SCORE_LIMIT = 100.0

#: Margins within which fp32 rounding may flip a decision: a logit (the
#: candidate threshold, the presence gate), an IoU, a score order between
#: interacting candidates, a crop size's half pixel at each crop size
#: (the face crop's size comes from the detector's keypoints, the eye
#: crops' from the mesh, the embedding crop's from the iris-refined eyes,
#: which the program and this reference place up to 6e-3 px apart on
#: noise frames), an iris-centre distance (px^2).
EPS_LOGIT = 1e-4
EPS_IOU = 1e-4
EPS_SCORE = 2e-5
EPS_PX = {192: 5e-3, 64: 2e-2, 112: 5e-2}
EPS_PX2 = 1.0

# Canonical mesh indices.
LEFT_EYE, RIGHT_EYE = (33, 133), (362, 263)
FOREHEAD, CHIN, LEFT_CHEEK, RIGHT_CHEEK = 10, 152, 234, 454

# The blendshape net's 146 landmarks of the 478-point layout (468 mesh +
# 10 iris), and the eyelid rings that come from the iris net's contour.
BLENDSHAPE_SUBSET = [
    0, 1, 4, 5, 6, 7, 8, 10, 13, 14, 17, 21, 33, 37, 39, 40, 46, 52, 53, 54,
    55, 58, 61, 63, 65, 66, 67, 70, 78, 80, 81, 82, 84, 87, 88, 91, 93, 95,
    103, 105, 107, 109, 127, 132, 133, 136, 144, 145, 146, 148, 149, 150,
    152, 153, 154, 155, 157, 158, 159, 160, 161, 162, 163, 168, 172, 173,
    176, 178, 181, 185, 191, 195, 197, 234, 246, 249, 251, 263, 267, 269,
    270, 276, 282, 283, 284, 285, 288, 291, 293, 295, 296, 297, 300, 308,
    310, 311, 312, 314, 317, 318, 321, 323, 324, 332, 334, 336, 338, 356,
    361, 362, 365, 373, 374, 375, 377, 378, 379, 380, 381, 382, 384, 385,
    386, 387, 388, 389, 390, 397, 398, 400, 402, 405, 409, 415, 454, 466,
    468, 469, 470, 471, 472, 473, 474, 475, 476, 477]
EYELID_FROM_IRIS = {
    33: 0, 7: 1, 163: 2, 144: 3, 145: 4, 153: 5, 154: 6, 155: 7, 133: 8,
    246: 9, 161: 10, 160: 11, 159: 12, 158: 13, 157: 14,
    263: 76, 249: 77, 390: 78, 373: 79, 374: 80, 380: 81, 381: 82, 382: 83,
    362: 84, 466: 85, 388: 86, 387: 87, 386: 88, 385: 89, 384: 90}


def _blendshape_rows():
    """(from_iris [146] bool, row [146]) of the 146-landmark gather."""
    from_iris, row = [], []
    for slot in BLENDSHAPE_SUBSET:
        if slot < 468:
            r = EYELID_FROM_IRIS.get(slot)
            from_iris.append(r is not None)
            row.append(slot if r is None else r)
        else:
            from_iris.append(True)
            k = slot - 468
            row.append(71 + k if k < 5 else 147 + k - 5)
    return np.asarray(from_iris), np.asarray(row)


def back_anchors() -> np.ndarray:
    """Anchor centres of the 256 px back-camera detector: 2 per cell of
    the 16x16 stride-16 layer, then 6 per cell of the 8x8 stride-32
    layers, cells in row-major order: ``[896, 2]`` (x, y)."""
    out = []
    for cells, per in ((16, 2), (8, 6)):
        for y in range(cells):
            for x in range(cells):
                out += [((x + 0.5) / cells, (y + 0.5) / cells)] * per
    return np.asarray(out, np.float32)


def letterbox_geometry(h: int, w: int, size: int, width: int | None = None):
    """(new_h, new_w, pad_top, pad_bottom, pad_left, pad_right) of the fit
    into ``size`` rows and ``width`` (else ``size``) columns."""
    width = width or size
    scale = min(width / w, size / h)
    new_w = min(width, max(1, int(math.floor(w * scale + 0.5))))
    new_h = min(size, max(1, int(math.floor(h * scale + 0.5))))
    pt, pl = (size - new_h) // 2, (width - new_w) // 2
    return new_h, new_w, pt, size - new_h - pt, pl, width - new_w - pl


def _taps(n_in: int, n_out: int, device):
    src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0,
                  n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float32)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.from_numpy(frac).to(device))


def letterbox(frames: torch.Tensor, size: int, width: int | None = None
              ) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> float ``[B, size, width or size, 3]`` in
    [-1, 1]."""
    b, h, w, _ = frames.shape
    nh, nw, pt, pb, pl, pr = letterbox_geometry(h, w, size, width)
    lo, hi, f = _taps(h, nh, frames.device)
    f = f[:, None, None]
    x = frames[:, lo].float() * (1.0 - f) + frames[:, hi].float() * f
    lo, hi, f = _taps(w, nw, frames.device)
    f = f[None, :, None]
    x = x[:, :, lo] * (1.0 - f) + x[:, :, hi] * f
    x = x * (1.0 / 127.5) - 1.0
    return torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb), value=-1.0)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of boxes ``a [n, 4]`` against ``b [m, 4]`` (float64)."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    iw = np.clip(np.minimum(a[:, None, 2], b[None, :, 2]) -
                 np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(a[:, None, 3], b[None, :, 3]) -
                 np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def weighted_nms(boxes, kps, scores, logits, max_faces: int):
    """One frame's candidates (float32 arrays) -> (leaders' boxes, kps,
    scores, logits, ambiguity reason or "")."""
    order = np.argsort(-scores, kind="stable")
    boxes, kps, scores, logits = (a[order] for a in (boxes, kps, scores,
                                                     logits))
    k = len(scores)
    iou = _iou(boxes.astype(np.float64), boxes.astype(np.float64))
    over = iou > IOU_THRESHOLD
    leader = np.zeros(k, bool)
    for j in range(k):
        leader[j] = not np.any(leader[:j] & over[:j, j])
    owner = np.full(k, k)
    for j in range(k):
        hits = np.nonzero(leader & over[:, j])[0]
        owner[j] = hits[0]
    why = ""
    near = np.abs(iou - IOU_THRESHOLD) < EPS_IOU
    for j in range(k):
        # Leaders up to j's owner decide j's suppression and ownership.
        if np.any(leader[:owner[j] + 1] & near[:owner[j] + 1, j]
                  & (np.arange(owner[j] + 1) != j)):
            why = "iou"
    touch = iou > IOU_THRESHOLD - EPS_IOU
    for a in range(k - 1):
        gap = float(scores[a]) - float(scores[a + 1])
        saturated = scores[a] == scores[a + 1] == 1.0 and min(
            logits[a], logits[a + 1]) > 17.5
        if gap < EPS_SCORE and not saturated and (
                touch[a, a + 1] or np.any(touch[a] & touch[a + 1])):
            why = "order"
    lead = np.nonzero(leader)[0]
    if len(lead) > max_faces:
        if float(scores[lead[max_faces - 1]]) - float(
                scores[lead[max_faces]]) < EPS_SCORE:
            why = "cut"
        lead = lead[:max_faces]
    out_boxes = []
    for i in lead:
        members = owner == i
        wts = scores[members].astype(np.float32)
        out_boxes.append((wts[:, None] * boxes[members]).sum(0) /
                         max(wts.sum(), np.float32(1e-12)))
    out_boxes = np.asarray(out_boxes, np.float32).reshape(-1, 4)
    return out_boxes, kps[lead], scores[lead], why


def _sample(frames, fidx, sx, sy):
    """Bilinear samples of uint8 ``frames [B, H, W, 3]`` at ``sx, sy
    [R, S, S]`` of frame ``fidx [R]``; outside taps read 0."""
    b, h, w, _ = frames.shape
    flat = frames.reshape(b, h * w, 3)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    bi = fidx[:, None, None]

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = flat[bi, yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)].float()
        return torch.where(inside[..., None], v, 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def crops(frames, fidx, cx, cy, size, theta, out: int, flip=None,
          block: int = 128):
    """Rotated square crops ``[R, out, out, 3]`` in [-1, 1]: the ROI of
    ``size`` px (rounded half up) about (cx, cy), the destination grid
    rotated by ``theta`` into the source, mirrored where ``flip``."""
    parts = []
    grid = torch.arange(out, dtype=torch.float32, device=frames.device)
    for i in range(0, len(cx), block):
        s = slice(i, i + block)
        size_int = torch.clamp_min(torch.floor(size[s] + 0.5), 1.0)
        scale = torch.full_like(size_int, out) / size_int
        oc = out / 2.0 + 0.5 * (scale - 1.0)
        dx = (grid[None, None, :] - oc[:, None, None]) / scale[:, None, None]
        dy = (grid[None, :, None] - oc[:, None, None]) / scale[:, None, None]
        ct = torch.cos(theta[s])[:, None, None]
        st = torch.sin(theta[s])[:, None, None]
        sx = cx[s][:, None, None] + ct * dx + st * dy
        sy = cy[s][:, None, None] - st * dx + ct * dy
        v = _sample(frames, fidx[s], sx, sy)
        if flip is not None:
            v = torch.where(flip[s][:, None, None, None], v.flip(2), v)
        parts.append(v * (1.0 / 127.5) - 1.0)
    if not parts:
        return torch.zeros((0, out, out, 3), device=frames.device)
    return torch.cat(parts)


def _half_pixel_gap(size: torch.Tensor) -> torch.Tensor:
    """How far a crop size lies from the half pixel where it rounds."""
    return (size - torch.floor(size) - 0.5).abs()


def head_angles(mesh: torch.Tensor) -> torch.Tensor:
    """(pitch, yaw, roll) in degrees with ML Kit's signs from the forehead,
    chin and cheek points of ``mesh [N, 468, 3]``; NaN where the frame is
    degenerate."""
    f, c = mesh[:, FOREHEAD], mesh[:, CHIN]
    left, right_pt = mesh[:, LEFT_CHEEK], mesh[:, RIGHT_CHEEK]
    right, down = right_pt - left, c - f

    def norm(v):
        return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))

    rlen, dlen = norm(right), norm(down)
    right = right / torch.clamp_min(rlen, 1e-12)
    down = down / torch.clamp_min(dlen, 1e-12)
    down = down - torch.sum(down * right, dim=-1, keepdim=True) * right
    dlen2 = norm(down)
    down = down / torch.clamp_min(dlen2, 1e-12)
    bz = right[:, 0] * down[:, 1] - right[:, 1] * down[:, 0]
    pitch = torch.atan2(down[:, 2], bz)
    yaw = torch.asin(torch.clamp(-right[:, 2], -1.0, 1.0))
    roll = torch.atan2(right[:, 1], right[:, 0])
    deg = 180.0 / math.pi
    ang = torch.stack([-pitch * deg, -yaw * deg, -roll * deg], dim=-1)
    bad = (rlen < 1e-6) | (dlen < 1e-6) | (dlen2 < 1e-6)
    return torch.where(bad, torch.full_like(ang, math.nan), ang)


class Reference:
    """The plain pipeline over the benchmark's graphs and weights."""

    def __init__(self, nets: dict, device, max_faces: int,
                 detector_size: int = 256):
        self.device = device
        self.max_faces = max_faces
        self.size = detector_size
        self.detector = Network(nets["detector"], device)
        self.mesh = Network(nets["mesh"], device)
        self.iris = Network(nets["iris"], device)
        self.blendshapes = Network(nets["blendshapes"], device)
        self.embedding = (MobileFaceNet(nets["embedding"], device)
                          if "embedding" in nets else None)
        self.anchors = torch.from_numpy(back_anchors()).to(device)
        from_iris, row = _blendshape_rows()
        self.bs_from_iris = torch.from_numpy(from_iris).to(device)
        self.bs_row = torch.from_numpy(row).to(device)

    def detector_logits(self, frames: torch.Tensor, operands=None
                        ) -> torch.Tensor:
        """Raw score logits ``[B, 896]`` of uint8 frames."""
        boxes, logits = self._detector(frames, operands)
        return logits

    def _detector(self, frames, operands):
        a, b = self.detector(letterbox(frames, self.size), operands)
        boxes, logits = (a, b) if a[0].numel() > b[0].numel() else (b, a)
        n = frames.shape[0]
        return boxes.reshape(n, -1, 16), logits.reshape(n, -1)

    def __call__(self, frames: torch.Tensor, operands=None,
                 block: int = 16) -> list[dict]:
        out = []
        for i in range(0, frames.shape[0], block):
            out += self._run(frames[i:i + block], operands)
        return out

    def count_faces(self, frames: torch.Tensor, block: int = 16
                    ) -> list[int]:
        """Detections a frame after the weighted NMS (uint8 frames)."""
        out = []
        for i in range(0, frames.shape[0], block):
            _, faces = self._detect(frames[i:i + block], None)
            out += [sum(1 for f in faces if f[0] == j)
                    for j in range(frames[i:i + block].shape[0])]
        return out

    def _run(self, frames, operands) -> list[dict]:
        frames_out, faces = self._detect(frames, operands)
        self._face_stages(frames, faces, frames_out, operands)
        return frames_out

    def _detect(self, frames, operands):
        """Steps 1-3: ([{"why", "faces": []}] a frame, [(frame, box, kp,
        score)] of every detection)."""
        b, h, w, _ = frames.shape
        size = float(self.size)
        raw, logits = self._detector(frames, operands)
        scaled = raw / torch.full((), size, device=raw.device)
        cxy = scaled[..., 0:2] + self.anchors
        wh = scaled[..., 2:4]
        kp = scaled[..., 4:16].reshape(b, -1, 6, 2) + self.anchors[:, None]
        boxes = torch.cat([cxy - wh * 0.5, cxy + wh * 0.5], dim=-1)
        scores = torch.sigmoid(torch.clamp(logits, -SCORE_LIMIT, SCORE_LIMIT))
        positive = (wh[..., 0] > 0) & (wh[..., 1] > 0)
        valid = (scores >= MIN_SCORE) & positive
        boxes, kp, scores, logits, valid, positive, wh = (
            t.cpu().numpy() for t in (boxes, kp, scores, logits, valid,
                                      positive, wh))
        _, _, pt, pb, pl, pr = letterbox_geometry(h, w, self.size)
        pt, pb, pl, pr = (p / self.size for p in (pt, pb, pl, pr))
        sx = np.float32(1.0 - (pl + pr))
        sy = np.float32(1.0 - (pt + pb))
        frames_out, faces = [], []
        for i in range(b):
            why = ""
            if np.any(positive[i] & (np.abs(logits[i]) < EPS_LOGIT)):
                why = "threshold"
            if np.any((scores[i] >= MIN_SCORE) & (np.abs(wh[i]).min(-1)
                                                  < 1e-6)):
                why = "degenerate box"
            v = valid[i]
            bx, kx, sc, nms_why = weighted_nms(boxes[i][v], kp[i][v],
                                               scores[i][v], logits[i][v],
                                               self.max_faces)
            bx = np.stack([(bx[:, 0] - pl) / sx, (bx[:, 1] - pt) / sy,
                           (bx[:, 2] - pl) / sx, (bx[:, 3] - pt) / sy],
                          axis=-1).astype(np.float32)
            kx = np.stack([(kx[..., 0] - pl) / sx, (kx[..., 1] - pt) / sy],
                          axis=-1).astype(np.float32)
            frames_out.append({"why": why or nms_why, "faces": []})
            for d in range(len(sc)):
                faces.append((i, bx[d], kx[d], float(sc[d])))
        return frames_out, faces

    def _face_stages(self, frames, faces, frames_out, operands):
        if not faces:
            return
        dev = frames.device
        h, w = frames.shape[1], frames.shape[2]
        fidx = torch.tensor([f[0] for f in faces], device=dev)
        kp = torch.from_numpy(np.stack([f[2] for f in faces])).to(dev)
        n = len(faces)
        # 4. the face ROI, the mesh.
        lx, ly = kp[:, 0, 0] * w, kp[:, 0, 1] * h
        rx, ry = kp[:, 1, 0] * w, kp[:, 1, 1] * h
        mx, my = kp[:, 3, 0] * w, kp[:, 3, 1] * h
        ecx, ecy = (lx + rx) * 0.5, (ly + ry) * 0.5
        vex, vey, vmx, vmy = rx - lx, ry - ly, mx - ecx, my - ecy
        theta = torch.atan2(vey, vex)
        fsize = torch.maximum(torch.sqrt(vmx * vmx + vmy * vmy) * 3.6,
                              torch.sqrt(vex * vex + vey * vey) * 4.0)
        cx, cy = ecx + vmx * 0.1, ecy + vmy * 0.1
        keep = torch.floor(fsize + 0.5) > 0
        lm, presence = self.mesh(crops(frames, fidx, cx, cy, fsize, -theta,
                                       192), operands)
        pts = lm.reshape(n, 468, 3)
        px = torch.clamp(pts[..., 0] / 192, 0, 1) - 0.5
        py = torch.clamp(pts[..., 1] / 192, 0, 1) - 0.5
        ct, st, s = (torch.cos(theta)[:, None], torch.sin(theta)[:, None],
                     fsize[:, None])
        mesh = torch.stack([cx[:, None] + s * (ct * px - st * py),
                            cy[:, None] + s * (st * px + ct * py),
                            pts[..., 2] / 192 * s], dim=-1)
        plogit = presence.reshape(n)
        mesh_score = torch.sigmoid(torch.clamp(plogit, -SCORE_LIMIT,
                                               SCORE_LIMIT))
        # 5. eye ROIs and the iris net.
        def eye(a, b):
            p0, p1 = mesh[:, a, :2], mesh[:, b, :2]
            c = (p0 + p1) * 0.5
            d = p1 - p0
            return (c[:, 0], c[:, 1], torch.sqrt(torch.sum(d * d, -1)) * 2.3,
                    torch.atan2(d[:, 1], d[:, 0]))
        eyes = [torch.stack(t, dim=1).reshape(-1) for t in
                zip(eye(*LEFT_EYE), eye(*RIGHT_EYE))]
        ex, ey, esize, etheta = eyes
        flip = (torch.arange(2 * n, device=dev) % 2 == 1)
        efidx = fidx.repeat_interleave(2)
        contour, iris = self.iris(crops(frames, efidx, ex, ey, esize, etheta,
                                        64, flip), operands)
        ip = torch.cat([contour, iris], dim=1).reshape(2 * n, 76, 3)
        ipx = torch.where(flip[:, None], 1.0 - ip[..., 0] / 64,
                          ip[..., 0] / 64) - 0.5
        ipy = ip[..., 1] / 64 - 0.5
        ect, est, es = (torch.cos(etheta)[:, None], torch.sin(etheta)[:, None],
                        esize[:, None])
        ilx, ily = ipx * es, ipy * es
        iris_abs = torch.stack([ex[:, None] + ilx * ect - ily * est,
                                ey[:, None] + ilx * est + ily * ect,
                                ip[..., 2]], dim=-1).reshape(n, 152, 3)
        # 6. blendshapes, head pose, iris-refined eye keypoints.
        packed = torch.where(self.bs_from_iris[:, None],
                             iris_abs[:, self.bs_row.clamp(max=151), :2],
                             mesh[:, self.bs_row.clamp(max=467), :2])
        (raw_bs,) = self.blendshapes(packed, operands)
        bs_ok = ~torch.isnan(raw_bs).any(dim=-1)
        bs = torch.clamp(torch.nan_to_num(raw_bs), 0.0, 1.0)
        angles = head_angles(mesh)
        centres, ties = [], []
        for lo in (71, 147):
            p = iris_abs[:, lo:lo + 5]
            d = torch.sum((p[..., :2] - p[..., :2].mean(1, keepdim=True))
                          ** 2, dim=-1)
            srt = torch.sort(d, dim=1).values
            ties.append(srt[:, 1] - srt[:, 0] < EPS_PX2)
            centres.append(p[torch.arange(n, device=dev), torch.argmin(d, 1)])
        refined = kp.clone()
        refined[:, 0, 0] = centres[0][:, 0] / w
        refined[:, 0, 1] = centres[0][:, 1] / h
        refined[:, 1, 0] = centres[1][:, 0] / w
        refined[:, 1, 1] = centres[1][:, 1] / h
        # 7. embeddings.
        emb = None
        emb_gap = torch.ones(n, device=dev)
        if self.embedding is not None:
            le_x, le_y = refined[:, 0, 0] * w, refined[:, 0, 1] * h
            re_x, re_y = refined[:, 1, 0] * w, refined[:, 1, 1] * h
            dx, dy = re_x - le_x, re_y - le_y
            th = torch.atan2(dy, dx)
            size = torch.sqrt(dx * dx + dy * dy) * 2.5
            off = size * 0.15
            ccx = (le_x + re_x) * 0.5 - off * torch.sin(th)
            ccy = (le_y + re_y) * 0.5 + off * torch.cos(th)
            e = self.embedding(crops(frames, fidx, ccx, ccy, size, -th, 112),
                               operands)
            nrm = torch.sqrt(torch.sum(e * e, dim=-1, keepdim=True))
            emb = torch.where(nrm > 0, e / nrm, e)
            emb_gap = _half_pixel_gap(size)
        rois = {192: torch.stack([cx, cy, fsize, -theta], 1),
                64: torch.stack([ex, ey, esize, etheta], 1).reshape(n, 2, 4)}
        if self.embedding is not None:
            rois[112] = torch.stack([ccx, ccy, size, -th], 1)
        face_gap = _half_pixel_gap(fsize)
        eye_gap = _half_pixel_gap(esize).reshape(n, 2).min(1).values
        tie = ties[0] | ties[1]
        host = {k: v.cpu().numpy() for k, v in dict(
            mesh=mesh, mesh_score=mesh_score, plogit=plogit, iris=iris_abs,
            bs=bs, bs_ok=bs_ok, angles=angles, kp=refined, keep=keep,
            face_gap=face_gap, eye_gap=eye_gap, tie=tie,
            emb_gap=emb_gap).items()}
        host_rois = {k: v.cpu().numpy() for k, v in rois.items()}
        if emb is not None:
            host["emb"] = emb.cpu().numpy()
        for j, (i, box, _, score) in enumerate(faces):
            fr = frames_out[i]
            if abs(host["plogit"][j]) < EPS_LOGIT:
                fr["why"] = fr["why"] or "presence"
            if not host["keep"][j] or host["mesh_score"][j] < PRESENCE:
                continue
            # Which outputs rounding may have sent down another path.
            skip = set()
            gaps = {192: float(host["face_gap"][j]),
                    64: float(host["eye_gap"][j]),
                    112: float(host["emb_gap"][j])}
            if gaps[192] < EPS_PX[192]:
                skip |= {"mesh", "iris", "bs", "angles", "eyes", "emb"}
            if gaps[64] < EPS_PX[64]:
                skip |= {"iris", "bs", "eyes", "emb"}
            if host["tie"][j]:
                skip |= {"eyes", "emb"}
            if gaps[112] < EPS_PX[112]:
                skip |= {"emb"}
            fr["faces"].append({
                "box": box, "score": score, "kp": host["kp"][j],
                "mesh": host["mesh"][j], "mesh_score": float(
                    host["mesh_score"][j]), "iris": host["iris"][j],
                "bs": host["bs"][j] if host["bs_ok"][j] else None,
                "angles": host["angles"][j],
                "emb": host["emb"][j] if "emb" in host else None,
                "rois": {k: v[j].reshape(-1, 4) for k, v in host_rois.items()},
                "gaps": gaps, "skip": skip})
