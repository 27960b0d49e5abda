"""Face embeddings: eye-based alignment, MobileFaceNet and the L2
normalisation.

Port of the JAX package's ``models/embedding.py`` (the reference's
`lib/src/models/face_embedding.dart`): the 112 px eye-aligned crop
(`computeEmbeddingAlignment`, face_embedding.dart:362-384: size =
2.5 * eye distance, centre 0.15 * size below the eye midpoint along the
crop's down axis), the 192-dim embedding, its L2 normalisation (:386-400)
and the cosine and euclidean comparisons (:283-334).

The crop is K2 (``ops/warp.py``, the ROI warp fused with the [-1, 1]
normalize) at 112 px with the alignment angle negated; the network runs on
cuDNN in fp32 with TF32 off, or at another tier of the executor
(``convert/executor.py``; "default" feeds the convolutions bf16 operands).  The trained ``mobilefacenet.tflite`` is not
in the repository: given one, :meth:`FaceEmbedding.load` converts it like
every other graph; otherwise it builds :class:`MobileFaceNet` at the
published widths with seeded weights, drawn as the JAX package draws
them, so that one seed gives the same weights in both packages.

Deliberate differences from the JAX module: :class:`MobileFaceNet` takes
any batch ``[N, 112, 112, 3]`` (the JAX function takes N = 1 and is
vmapped), and :meth:`FaceEmbedding.embed_batch` runs exactly N crops (the
JAX one pads N to a power of two to bound its compiles).
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert.checkpoint import load_params_npz, swap_params
from ..convert.executor import (_TIER_DTYPE, _check_fp32, _refresh_low,
                                _same_pads, _tier, convert_file,
                                fp32_on_the_card, resolve_device)
from ..ops.warp import extract_rois_normalized
from ..pipeline.config import EMBEDDING_DIM, EMBEDDING_INPUT_SIZE
from ..pipeline.timings import stage_range

__all__ = ["compute_embedding_alignment", "alignment_from_eyes",
           "embed_rois", "FaceEmbedding", "MobileFaceNet", "cosine_similarity",
           "euclidean_distance", "build_mobilefacenet", "params_from_jax",
           "UntrainedEmbeddingWarning"]


class UntrainedEmbeddingWarning(UserWarning):
    """Warned when embeddings come from random-init weights.

    The reference ships a trained ``mobilefacenet.tflite``; it is not in
    this repository, so without a trained file the network runs on seeded
    random weights: the vectors are structurally valid but do not tell
    identities apart, and ``compare_faces`` on them means nothing.  Pass
    ``allow_untrained=True`` (or provide the trained file) to acknowledge
    and silence this.
    """


def compute_embedding_alignment(left_eye, right_eye):
    """ROI ``(cx, cy, size, theta)`` from the eye centres (absolute
    pixels), on the host in Python floats (`face_embedding.dart:362-384`)."""
    dx = right_eye[0] - left_eye[0]
    dy = right_eye[1] - left_eye[1]
    theta = math.atan2(dy, dx)
    eye_dist = math.hypot(dx, dy)
    size = eye_dist * 2.5
    eye_cx = (left_eye[0] + right_eye[0]) * 0.5
    eye_cy = (left_eye[1] + right_eye[1]) * 0.5
    off = size * 0.15
    cx = eye_cx - off * math.sin(theta)
    cy = eye_cy + off * math.cos(theta)
    return cx, cy, size, theta


def roi_ok(size: float) -> bool:
    """Whether an aligned crop of ``size`` px rounds to at least 1 px (NaN
    fails): the one rule for which eye pairs can be embedded."""
    return size > 0 and int(math.floor(size + 0.5)) >= 1


def alignment_from_eyes(le_x, le_y, re_x, re_y):
    """:func:`compute_embedding_alignment` over float32 tensors of eye
    coordinates, for the fused program: returns (cx, cy, size, theta).
    Keep the two forms in lockstep."""
    dx = re_x - le_x
    dy = re_y - le_y
    theta = torch.atan2(dy, dx)
    size = torch.sqrt(dx * dx + dy * dy) * 2.5
    off = size * 0.15
    cx = (le_x + re_x) * 0.5 - off * torch.sin(theta)
    cy = (le_y + re_y) * 0.5 + off * torch.cos(theta)
    return cx, cy, size, theta


def embed_rois(model, frames: torch.Tensor, cx, cy, sizes, theta
               ) -> torch.Tensor:
    """THE embedding math, shared by :class:`FaceEmbedding` and the fused
    FULL stage: ``frames [B, H, W, 3]`` and ``[B, F]`` ROIs -> ``[B, F, D]``
    unit embeddings.  K2 crops at 112 px with the negated angle
    (face_detector_core.dart:433-440) in one launch, the network runs once
    on ``[B * F, 112, 112, 3]``, then the L2 normalisation
    (face_embedding.dart:386-400)."""
    crops = extract_rois_normalized(frames, cx, cy, sizes, -theta,
                                    out_size=EMBEDDING_INPUT_SIZE)
    b, f = crops.shape[:2]
    (emb,) = model(crops.reshape(b * f, EMBEDDING_INPUT_SIZE,
                                 EMBEDDING_INPUT_SIZE, 3))
    emb = emb.reshape(b, f, -1)
    norm = torch.sqrt(torch.sum(emb * emb, dim=-1, keepdim=True))
    return torch.where(norm > 0, emb / norm, emb)


def cosine_similarity(a, b) -> float:
    """`face_embedding.dart:283-302`."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"Embedding dimensions must match: "
                         f"{a.shape} vs {b.shape}")
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom > 0 else 0.0


def euclidean_distance(a, b) -> float:
    """`face_embedding.dart:304-334`."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"Embedding dimensions must match: "
                         f"{a.shape} vs {b.shape}")
    return float(np.linalg.norm(a - b))


# ---------------------------------------------------------------------------
# MobileFaceNet (inference form, batch norm folded away).
# ---------------------------------------------------------------------------

# (expand, channels, repeats, stride): MobileFaceNet's bottlenecks (Chen et
# al. 2018, Table 1).
_MFN_BLOCKS = [(2, 64, 5, 2), (4, 128, 1, 2), (2, 128, 6, 1),
               (4, 128, 1, 2), (2, 128, 2, 1)]


def _mfn_layers(embedding_dim: int) -> list[tuple]:
    """``(name, kh, kw, c_in, c_out, groups, prelu)`` of every convolution,
    in the order in which the JAX package draws their weights."""
    layers = [("stem", 3, 3, 3, 64, 1, True),
              ("stem_dw", 3, 3, 64, 64, 64, True)]
    c_in = 64
    for bi, (t, c, n, _) in enumerate(_MFN_BLOCKS):
        for ri in range(n):
            name = f"b{bi}_{ri}"
            layers += [(f"{name}_e", 1, 1, c_in, c_in * t, 1, True),
                       (f"{name}_d", 3, 3, c_in * t, c_in * t, c_in * t, True),
                       (f"{name}_p", 1, 1, c_in * t, c, 1, False)]
            c_in = c
    return layers + [("head", 1, 1, c_in, 512, 1, True),
                     ("gdconv", 7, 7, 512, 512, 512, False),
                     ("out", 1, 1, 512, embedding_dim, 1, False)]


def params_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX ``build_mobilefacenet`` params (filters in HWIO) as the state
    dict of :class:`MobileFaceNet` (filters in OIHW); the keys stay."""
    return {k: torch.from_numpy(np.array(
        np.asarray(v).transpose(3, 2, 0, 1) if k.endswith("_w") else v,
        order="C")) for k, v in params.items()}


class MobileFaceNet(nn.Module):
    """MobileFaceNet-112: ``forward(x [N, 112, 112, 3])`` (NHWC, in [-1, 1])
    returns ``([N, embedding_dim],)``, as a converted graph returns its
    outputs.

    Convolutions use TF-style SAME pads, which are asymmetric at stride 2
    (0 before, 1 after on an even input); the final 7x7 global depthwise
    convolution is VALID; PReLU is ``where(y >= 0, y, y * a)``; a
    bottleneck adds its input where its stride is 1 and its channels stay.
    Weights are buffers keyed as the JAX params.  ``precision`` is a tier
    of the executor for every convolution ("highest", "high" or
    "default"; the JAX function's ``precision``): at "default" they take
    bf16 operands (the filters' bf16 copies are non-persistent buffers,
    re-derived when a state dict loads) and the bias and PReLU run in
    fp32.
    """

    def __init__(self, embedding_dim: int = EMBEDDING_DIM,
                 name: str = "mobilefacenet", precision: str = "highest"):
        super().__init__()
        self.name = name
        self.precision = precision
        self._dtype = _TIER_DTYPE[_tier(precision)]
        self.input_shapes = [(1, EMBEDDING_INPUT_SIZE, EMBEDDING_INPUT_SIZE,
                              3)]
        self.output_shapes = [(1, embedding_dim)]
        for lname, kh, kw, c_in, c_out, groups, prelu in _mfn_layers(
                embedding_dim):
            w = torch.zeros(c_out, c_in // groups, kh, kw)
            if groups == 1:
                w = w.contiguous(memory_format=torch.channels_last)
            self.register_buffer(f"{lname}_w", w)
            self.register_buffer(f"{lname}_b", torch.zeros(c_out))
            if prelu:
                self.register_buffer(f"{lname}_a", torch.zeros(c_out))
        self._make_low()
        self.register_load_state_dict_post_hook(_refresh_low)

    def _make_low(self) -> None:
        """(Re)makes the filters' copies in the tier's operand dtype."""
        if self._dtype is torch.float32:
            return
        for key in [k for k in self._buffers
                    if k.endswith("_w") and not k.startswith("_bf_")]:
            self.register_buffer(f"_bf_{key}", self._buffers[key].to(
                self._dtype, memory_format=torch.preserve_format),
                persistent=False)

    @property
    def num_params(self) -> int:
        return sum(b.numel() for b in self.state_dict().values())

    def jax_params(self) -> dict[str, np.ndarray]:
        """The weights as the JAX ``build_mobilefacenet`` params (the same
        keys, filters in HWIO)."""
        return {k: np.ascontiguousarray(
            (v.permute(2, 3, 1, 0) if k.endswith("_w") else v).cpu().numpy())
            for k, v in self.state_dict().items()}

    def load_jax_params(self, params: dict[str, np.ndarray]
                        ) -> "MobileFaceNet":
        self.load_state_dict(params_from_jax(params))
        return self

    def _conv(self, name: str, x, stride: int = 1, groups: int = 1,
              prelu: bool = True, same: bool = True):
        low = self._dtype is not torch.float32
        w = getattr(self, f"_bf_{name}_w" if low else f"{name}_w")
        if low:
            x = x.to(self._dtype)
        pad = (0, 0)
        if same:
            (pt, pb), (pl, pr) = (_same_pads(x.shape[2], stride, w.shape[2]),
                                  _same_pads(x.shape[3], stride, w.shape[3]))
            if pt == pb and pl == pr:
                pad = (pt, pl)
            else:
                x = F.pad(x, (pl, pr, pt, pb))
        b = getattr(self, f"{name}_b")
        if low:
            # The bias and PReLU run in fp32, after the TPU's conv with
            # preferred_element_type=float32.
            y = F.conv2d(x, w, None, stride=stride, padding=pad,
                         groups=groups).float() + b[:, None, None]
        else:
            y = F.conv2d(x, w, b, stride=stride, padding=pad, groups=groups)
        if prelu:
            a = getattr(self, f"{name}_a")[:, None, None]
            y = torch.where(y >= 0, y, y * a)
        return y

    def _bottleneck(self, name: str, x, expand: int, out_c: int,
                    stride: int):
        c_in = x.shape[1]
        h = self._conv(f"{name}_e", x)                          # 1x1 expand
        h = self._conv(f"{name}_d", h, stride=stride,
                       groups=c_in * expand)                    # 3x3 dw
        h = self._conv(f"{name}_p", h, prelu=False)             # 1x1 project
        return h + x if stride == 1 and c_in == out_c else h

    def forward(self, x: torch.Tensor):
        s = EMBEDDING_INPUT_SIZE
        if x.dim() != 4 or tuple(x.shape[1:]) != (s, s, 3) or x.shape[0] < 1:
            raise ValueError(f"embedding input expects shape (N, {s}, {s}, 3)"
                             f" with N >= 1, got {tuple(x.shape)}")
        h = x.permute(0, 3, 1, 2)       # a channels_last view, no copy
        _check_fp32(x.device, bf16=self._dtype is not torch.float32)
        h = self._conv("stem", h, stride=2)
        h = self._conv("stem_dw", h, groups=64)
        for bi, (t, c, n, stride) in enumerate(_MFN_BLOCKS):
            for ri in range(n):
                h = self._bottleneck(f"b{bi}_{ri}", h, t, c,
                                     stride if ri == 0 else 1)
        h = self._conv("head", h)
        # The global depthwise 7x7 VALID collapses the spatial dims.
        h = self._conv("gdconv", h, groups=512, prelu=False, same=False)
        h = self._conv("out", h, prelu=False)
        return (h.reshape(h.shape[0], -1),)


def build_mobilefacenet(seed: int = 0, embedding_dim: int = EMBEDDING_DIM,
                        precision: str = "highest") -> MobileFaceNet:
    """MobileFaceNet-112 with seeded He-init weights (batch norm folded
    away), on the CPU.  The weights are bit for bit those of the JAX
    package's ``build_mobilefacenet(seed)``; ``precision`` is the tier of
    its convolutions (:class:`MobileFaceNet`)."""
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}
    for name, kh, kw, c_in, c_out, groups, prelu in _mfn_layers(
            embedding_dim):
        fan_in = kh * kw * (c_in // groups)
        params[f"{name}_w"] = rng.normal(
            0, math.sqrt(2.0 / fan_in),
            (kh, kw, c_in // groups, c_out)).astype(np.float32)
        params[f"{name}_b"] = np.zeros((c_out,), np.float32)
        if prelu:
            params[f"{name}_a"] = np.full((c_out,), 0.25, np.float32)
    return MobileFaceNet(embedding_dim, name="mobilefacenet-random-init",
                         precision=precision).load_jax_params(params)


class FaceEmbedding:
    """Eye-aligned face embeddings on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, model: nn.Module, *, allow_untrained: bool = False,
                 device=None):
        self.device = resolve_device(device)
        fp32_on_the_card(self.device)
        self.model = model.to(self.device).eval()
        self.is_pretrained = "random-init" not in model.name
        self.allow_untrained = allow_untrained

    @classmethod
    def load(cls, tflite_path: Optional[str] = None, *,
             allow_untrained: bool = False, device=None) -> "FaceEmbedding":
        """Loads a ``mobilefacenet.tflite``, a ``.npz`` checkpoint of the
        JAX ``build_mobilefacenet`` params (``convert/checkpoint.py``,
        validated), or, for ``tflite_path=None``, builds the seeded
        random-weight network (every embed call then warns with
        :class:`UntrainedEmbeddingWarning` unless ``allow_untrained``).
        The parameter keeps the JAX package's name, so a caller passing it
        by keyword runs on both.

        An explicit path that does not exist raises FileNotFoundError:
        falling back there would let a mistyped path produce meaningless
        similarities without a signal."""
        if tflite_path:
            if not os.path.exists(tflite_path):
                raise FileNotFoundError(
                    f"embedding model not found: {tflite_path} (pass "
                    "tflite_path=None to use the random-init fallback)")
            if tflite_path.endswith(".npz"):
                return cls(swap_params(build_mobilefacenet(),
                                       load_params_npz(tflite_path),
                                       name="mobilefacenet-imported"),
                           device=device)
            return cls(convert_file(tflite_path), device=device)
        return cls(build_mobilefacenet(), allow_untrained=allow_untrained,
                   device=device)

    def _check_trained(self) -> None:
        if not self.is_pretrained and not self.allow_untrained:
            warnings.warn(
                "Face embeddings are computed with RANDOM-INIT MobileFaceNet "
                "weights (mobilefacenet.tflite not found): vectors are not "
                "identity-discriminative and compare_faces results are "
                "meaningless.  Provide the trained model file or pass "
                "allow_untrained=True to acknowledge.",
                UntrainedEmbeddingWarning, stacklevel=3)

    @staticmethod
    def _check_roi(size: float) -> None:
        """Coincident or near-coincident eyes make the aligned crop round
        to 0 px; the reference's extractAlignedSquare returns null there
        and getFaceEmbedding throws (`face_detector_core.dart:433-440`)."""
        if not roi_ok(size):
            raise ValueError(
                "Failed to extract aligned face crop for embedding: eye "
                "points are coincident or too close (crop size rounds "
                "to 0)")

    def _frame(self, image) -> torch.Tensor:
        """``[1, H, W, 3]`` frame on the device: a host array is uploaded,
        a tensor already on the device passes through."""
        t = image if isinstance(image, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(image))
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"expected an [H, W, 3] RGB image, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.uint8:
            t = t.float()
        return t.to(self.device)[None].contiguous()

    def embed(self, image, left_eye, right_eye) -> np.ndarray:
        """L2-normalised embedding from an RGB image (numpy ``[H, W, 3]``
        or a tensor on the device) and the eye centres in pixels."""
        return self.embed_batch(image, [(left_eye, right_eye)])[0]

    def embed_batch(self, image, eye_pairs) -> np.ndarray:
        """Embeds N faces of ONE image: ``eye_pairs`` is a sequence of
        (left_eye, right_eye) pixel points; returns ``[N, 192]``.  One K2
        launch cuts the N crops and the network runs once on them, in the
        ``fdt.embed`` range."""
        if self.model is None:
            raise RuntimeError("FaceEmbedding has been disposed")
        self._check_trained()
        aligns = [compute_embedding_alignment(le, re) for le, re in eye_pairs]
        for a in aligns:
            self._check_roi(a[2])
        if not aligns:
            return np.zeros((0, EMBEDDING_DIM), np.float32)
        with stage_range("fdt.embed"):
            frame = self._frame(image)
            # Float64 on the host, float32 on the device, as the JAX
            # package.
            roi = torch.from_numpy(np.asarray(aligns, np.float32).T[:, None]
                                   .copy()).to(self.device)
            with torch.inference_mode():
                out = embed_rois(self.model, frame, *roi)
            return out[0].cpu().numpy()

    def dispose(self) -> None:
        """Frees the weights; later embeds raise
        (`face_embedding.dart:343`)."""
        self.model = None

    # Static helpers mirroring the reference API.
    cosine_similarity = staticmethod(cosine_similarity)
    euclidean_distance = staticmethod(euclidean_distance)
