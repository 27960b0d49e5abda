"""Seeded full-width BlazeFace-back, FaceMesh, iris and blendshape graphs,
built in numpy.

The trained MediaPipe ``.tflite`` files are not part of the repository, so
the port's main path runs the published topologies with seeded weights
instead.  Each network is a :class:`~..convert.tflite.ModelIR` — the IR
that ``parse_tflite`` produces — made of the op mix the real files use
(CONV_2D, DEPTHWISE_CONV_2D, ADD with a fused ReLU, PAD, MAX_POOL_2D,
PRELU, RESHAPE, CONCATENATION; for the blendshape MLP-Mixer
FULLY_CONNECTED, TRANSPOSE, GELU, LOGISTIC and the layer-norm ops, with
fp16 weights behind DEQUANTIZE), at the published widths and
resolutions, or, where no width is published, at the parameter count of
the published file.
The same IR runs through this package's executor and through the JAX
package's, so both compute the same function on the same weights.

Topologies (public descriptions):

* BlazeFace back: MediaPipe's BlazeFace model card and ``blazeface.py``
  with ``back_model=True`` in hollance/BlazeFace-PyTorch.  256x256x3 in;
  5x5/2 conv to 24 ch; BlazeBlocks (depthwise 3x3, pointwise 1x1,
  residual add with ReLU; a stride-2 block max-pools and channel-pads its
  residual) in stages of 24, 24, 48 and 96 channels down to 16x16; a
  final stride-2 block to 8x8x96; 1x1 heads of 2 scores + 32 box values
  at 16x16 and 6 + 96 at 8x8, reshaped and concatenated to
  ``[1, 896, 16]`` and ``[1, 896, 1]`` in ``generate_anchors(SSD_BACK)``
  order.
* FaceMesh: MediaPipe's Face Mesh model card and
  ``blazeface_landmark.py`` in zmurez/MediaPipePyTorch.  192x192x3 in;
  3x3/2 conv to 16 ch with PReLU; PReLU BlazeBlocks at 16, 32, 64, 128
  and 128 channels down to 6x6x128; a landmark head (stride-2 block to
  3x3, 1x1 to 32, one block, 3x3 VALID conv to ``[1, 1, 1, 1404]``) and
  a presence head ending in ``[1, 1, 1, 1]``.
* Iris landmarks and blendshapes: :func:`iris_landmark_ir` and
  :func:`face_blendshapes_ir` give their layouts.

Weights use fan-in scaling with the residual branch scaled down, so that
activations stay O(1) through full depth.  The detector's box head is
biased to a face-like keypoint layout and its score head is shifted by
:func:`calibrate_score_bias` so that a few dozen anchors per frame pass
``MIN_SCORE``.  This module is a test and smoke-run fixture, not a user
feature.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert.executor import convert_model, fp32_on_the_card
from ..convert.tflite import (PADDING_SAME, PADDING_VALID, ModelIR, OpIR,
                              TensorIR)
from ..ops.letterbox import letterbox_image, letterbox_params
from ..pipeline.programs import PipelineModels
from .embedding import build_mobilefacenet

__all__ = ["blazeface_back_ir", "face_mesh_ir", "iris_landmark_ir",
           "face_blendshapes_ir", "calibrate_score_bias",
           "random_pipeline_models", "random_raw_detections",
           "BLAZEFACE_BLOCKS", "MESH_BLOCKS", "IRIS_BLOCKS", "MIXER_BLOCKS"]

#: Full depth: non-strided blocks per stage of the published topologies,
#: and Mixer blocks of the blendshape net.
BLAZEFACE_BLOCKS = 7
MESH_BLOCKS = 2
IRIS_BLOCKS = 4
MIXER_BLOCKS = 4

# Residual-branch gain: keeps activations O(1) over ~30 residual blocks.
_RES_GAIN = 0.35

# Box-head bias in 256-px detector-input units: (cx, cy, w, h) then the six
# keypoints (left eye, right eye, nose tip, mouth, left and right tragion).
_BOX_BIAS = np.asarray([0, 0, 44, 44,
                        -9, -8, 9, -8, 0, 2, 0, 12, -20, -4, 20, -4],
                       np.float32)

# FaceMesh landmark-head bias of the eye corners in 192-px crop units: mesh
# point -> (x, y).  Outer and inner corners of the image-left eye (33, 133)
# and inner and outer of the image-right eye (362, 263): eyes 26 px wide,
# 26 px apart, on one row, as in MediaPipe's canonical face.
_EYE_CORNERS = {33: (57.0, 80.0), 133: (83.0, 80.0),
                362: (109.0, 80.0), 263: (135.0, 80.0)}


class _Graph:
    """Appends tensors and ops to a ModelIR under construction."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.tensors: list[TensorIR] = []
        self.ops: list[OpIR] = []

    def tensor(self, shape, data=None, dtype=np.float32) -> int:
        i = len(self.tensors)
        self.tensors.append(TensorIR(i, f"t{i}", tuple(int(d) for d in shape),
                                     dtype, data))
        return i

    def const(self, arr: np.ndarray) -> int:
        return self.tensor(arr.shape, arr, arr.dtype.type)

    def shape(self, t: int) -> tuple[int, ...]:
        return self.tensors[t].shape

    def op(self, name, inputs, out_shape, **options) -> int:
        out = self.tensor(out_shape)
        self.ops.append(OpIR(name, list(inputs), [out], options))
        return out

    def ir(self, inputs, outputs, description) -> ModelIR:
        return ModelIR(self.tensors, self.ops, list(inputs), list(outputs),
                       description)

    # -- layers ------------------------------------------------------------

    def conv(self, x, cout, k, stride=1, padding=PADDING_SAME, act=None,
             gain=1.0, bias=None, weights=None):
        _, h, w, cin = self.shape(x)
        wt = self.rng.normal(0.0, gain * np.sqrt(2.0 / (k * k * cin)),
                             (cout, k, k, cin)).astype(np.float32)
        if weights == "zero_sum":
            wt -= wt.mean(axis=(1, 2, 3), keepdims=True)
        elif weights == "positive":
            wt = np.abs(wt)
        b = (np.zeros(cout, np.float32) if bias is None
             else np.asarray(bias, np.float32))
        if padding == PADDING_SAME:
            oh, ow = -(-h // stride), -(-w // stride)
        else:
            oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
        return self.op("CONV_2D", [x, self.const(wt), self.const(b)],
                       (1, oh, ow, cout), padding=padding, stride_w=stride,
                       stride_h=stride, activation=act, dilation_w=1,
                       dilation_h=1)

    def depthwise(self, x, stride):
        _, h, w, c = self.shape(x)
        if stride == 2:
            # Explicit (0, 2) spatial pad then VALID, as the exported graphs do.
            x = self.pad(x, [[0, 0], [0, 2], [0, 2], [0, 0]])
            h, w = h + 2, w + 2
            padding, oh, ow = PADDING_VALID, (h - 3) // 2 + 1, (w - 3) // 2 + 1
        else:
            padding, oh, ow = PADDING_SAME, h, w
        wt = self.rng.normal(0.0, np.sqrt(1.0 / 9.0),
                             (1, 3, 3, c)).astype(np.float32)
        return self.op("DEPTHWISE_CONV_2D",
                       [x, self.const(wt), self.const(np.zeros(c, np.float32))],
                       (1, oh, ow, c), padding=padding, stride_w=stride,
                       stride_h=stride, depth_multiplier=1, activation=None,
                       dilation_w=1, dilation_h=1)

    def pad(self, x, pads):
        shp = [d + a + b for d, (a, b) in zip(self.shape(x), pads)]
        return self.op("PAD", [x, self.const(np.asarray(pads, np.int32))], shp)

    def prelu(self, x):
        c = self.shape(x)[3]
        alpha = self.rng.uniform(0.1, 0.3, (1, 1, c)).astype(np.float32)
        return self.op("PRELU", [x, self.const(alpha)], self.shape(x))

    def block(self, x, cout, stride=1, prelu=False):
        """BlazeBlock: dw 3x3 -> pw 1x1 (+ residual) -> ReLU / PReLU."""
        _, h, w, cin = self.shape(x)
        y = self.conv(self.depthwise(x, stride), cout, 1, gain=_RES_GAIN)
        res = x
        if stride == 2:
            res = self.op("MAX_POOL_2D", [res], (1, h // 2, w // 2, cin),
                          padding=PADDING_VALID, stride_w=2, stride_h=2,
                          filter_w=2, filter_h=2, activation=None)
        if cout > cin:
            res = self.pad(res, [[0, 0], [0, 0], [0, 0], [0, cout - cin]])
        out = self.op("ADD", [y, res], self.shape(y),
                      activation=None if prelu else "RELU")
        return self.prelu(out) if prelu else out

    def half(self, arr: np.ndarray) -> int:
        """A constant stored as float16 behind a DEQUANTIZE op, the form
        of the fp16 ``.tflite`` files' weights."""
        return self.op("DEQUANTIZE", [self.const(arr.astype(np.float16))],
                       arr.shape)

    def fc(self, x, cout, gain=1.0, bias_std=0.0):
        """FULLY_CONNECTED over the last axis (keep_num_dims), fp16
        weights [cout, cin] with fan-in scaling."""
        cin = self.shape(x)[-1]
        w = self.rng.normal(0.0, gain / np.sqrt(cin), (cout, cin))
        b = self.rng.normal(0.0, bias_std, cout)
        return self.op("FULLY_CONNECTED", [x, self.half(w), self.half(b)],
                       self.shape(x)[:-1] + (cout,), activation=None,
                       keep_num_dims=True)

    def mean(self, x, axes):
        shp = tuple(1 if i in axes else d for i, d in enumerate(self.shape(x)))
        return self.op("MEAN", [x, self.const(np.asarray(axes, np.int32))],
                       shp, keep_dims=True)

    def layer_norm(self, x, eps=1e-6):
        """Layer norm over the last axis in the ops TensorFlow emits for
        ``keras.layers.LayerNormalization``: MEAN, NEG, SQUARED_DIFFERENCE,
        MEAN, ADD, RSQRT, MUL and ADD."""
        c = self.shape(x)[-1]
        last = len(self.shape(x)) - 1
        m = self.mean(x, [last])
        var = self.mean(self.op("SQUARED_DIFFERENCE", [x, m], self.shape(x)),
                        [last])
        r = self.op("RSQRT", [self.op(
            "ADD", [var, self.const(np.asarray(eps, np.float32))],
            self.shape(var), activation=None)], self.shape(var))
        gamma = self.half(1.0 + self.rng.normal(0.0, 0.1, (1, 1, c)))
        beta = self.half(self.rng.normal(0.0, 0.1, (1, 1, c)))
        s = self.op("MUL", [r, gamma], self.shape(x), activation=None)
        shift = self.op("ADD", [self.op(
            "MUL", [self.op("NEG", [m], self.shape(m)), s], self.shape(x),
            activation=None), beta], self.shape(x), activation=None)
        return self.op("ADD", [self.op("MUL", [x, s], self.shape(x),
                                       activation=None), shift],
                       self.shape(x), activation=None)

    def transpose(self, x, perm):
        shp = tuple(self.shape(x)[p] for p in perm)
        return self.op("TRANSPOSE", [x, self.const(np.asarray(perm,
                                                              np.int32))],
                       shp)

    def mlp(self, x, hidden):
        """FC -> GELU -> FC back to the input width (scaled down as a
        residual branch)."""
        y = self.fc(x, hidden, bias_std=0.1)
        y = self.op("GELU", [y], self.shape(y), approximate=False)
        return self.fc(y, self.shape(x)[-1], gain=_RES_GAIN, bias_std=0.1)

    def head(self, x, per_anchor, gain, bias, weights=None):
        """1x1 head flattened to [1, cells * anchors, per_anchor]."""
        _, h, w, _ = self.shape(x)
        y = self.conv(x, bias.size, 1, gain=gain, bias=bias, weights=weights)
        shp = np.asarray([1, h * w * bias.size // per_anchor, per_anchor],
                         np.int32)
        return self.op("RESHAPE", [y, self.const(shp)], tuple(shp),
                       new_shape=shp.tolist())


def blazeface_back_ir(seed: int = 0,
                      blocks_per_stage: int = BLAZEFACE_BLOCKS) -> ModelIR:
    """The BlazeFace back-camera detector (256 px, 896 anchors)."""
    g = _Graph(np.random.default_rng(seed))
    inp = g.tensor((1, 256, 256, 3))
    x = g.pad(inp, [[0, 0], [1, 2], [1, 2], [0, 0]])
    # Zero-sum stem filters and bias-free blocks make the features of a
    # flat region (the letterbox padding) exactly 0, and positive score
    # weights then leave padding anchors the lowest logit: detections land
    # on image content, as a trained detector's do.
    x = g.conv(x, 24, 5, stride=2, padding=PADDING_VALID, act="RELU",
               weights="zero_sum")
    for i, cout in enumerate((24, 24, 48, 96)):
        if i:
            x = g.block(x, cout, stride=2)
        for _ in range(blocks_per_stage):
            x = g.block(x, cout)
    x16 = x                                          # 16x16x96
    x = g.pad(x16, [[0, 0], [0, 2], [0, 2], [0, 0]])
    x = g.op("DEPTHWISE_CONV_2D",
             [x, g.const(g.rng.normal(0, 1 / 3, (1, 3, 3, 96))
                         .astype(np.float32)),
              g.const(np.zeros(96, np.float32))],
             (1, 8, 8, 96), padding=PADDING_VALID, stride_w=2, stride_h=2,
             depth_multiplier=1, activation=None, dilation_w=1, dilation_h=1)
    x8 = g.conv(x, 96, 1, act="RELU")                # 8x8x96
    scores, boxes = [], []
    for feat, anchors in ((x16, 2), (x8, 6)):
        scores.append(g.head(feat, 1, 0.5, np.zeros(anchors, np.float32),
                             weights="positive"))
        boxes.append(g.head(feat, 16, 0.25, np.tile(_BOX_BIAS, anchors)))
    box = g.op("CONCATENATION", boxes, (1, 896, 16), axis=1, activation=None)
    score = g.op("CONCATENATION", scores, (1, 896, 1), axis=1,
                 activation=None)
    return g.ir([inp], [box, score], f"random BlazeFace back, seed {seed}")


def face_mesh_ir(seed: int = 0, blocks_per_stage: int = MESH_BLOCKS
                 ) -> ModelIR:
    """The 468-point FaceMesh landmark net (192 px) with its presence head.

    The landmark head's biases scatter the points over [40, 152] px of the
    crop, except the eye corners (:data:`_EYE_CORNERS`), which sit where
    a trained mesh puts them, so that the eye ROIs come out about a third
    of the face ROI's size."""
    g = _Graph(np.random.default_rng(seed))
    inp = g.tensor((1, 192, 192, 3))
    x = g.pad(inp, [[0, 0], [0, 1], [0, 1], [0, 0]])
    x = g.prelu(g.conv(x, 16, 3, stride=2, padding=PADDING_VALID))
    for i, cout in enumerate((16, 32, 64, 128, 128)):
        if i:
            x = g.block(x, cout, stride=2, prelu=True)
        for _ in range(blocks_per_stage):
            x = g.block(x, cout, prelu=True)
    feat = x                                         # 6x6x128
    y = g.block(feat, 128, stride=2, prelu=True)     # 3x3
    for _ in range(blocks_per_stage):
        y = g.block(y, 128, prelu=True)
    y = g.prelu(g.conv(y, 32, 1))
    y = g.block(y, 32, prelu=True)
    lm_bias = np.zeros((468, 3), np.float32)
    lm_bias[:, :2] = g.rng.uniform(40.0, 152.0, (468, 2))
    lm_bias[list(_EYE_CORNERS), :2] = list(_EYE_CORNERS.values())
    lm_bias[:, 2] = g.rng.uniform(-10.0, 10.0, 468)
    lm = g.conv(y, 1404, 3, padding=PADDING_VALID, gain=0.5,
                bias=lm_bias.reshape(-1))
    p = g.block(feat, 128, stride=2, prelu=True)
    presence = g.conv(p, 1, 3, padding=PADDING_VALID, gain=0.05,
                      bias=np.asarray([3.0], np.float32))
    return g.ir([inp], [lm, presence], f"random FaceMesh, seed {seed}")


def iris_landmark_ir(seed: int = 0, blocks_per_stage: int = IRIS_BLOCKS
                     ) -> ModelIR:
    """The iris landmark net (64 px): ``[1, 71 * 3]`` eye contour, then
    ``[1, 5 * 3]`` iris, in crop pixels.

    64x64x3 in; 3x3/2 conv to 64 ch with PReLU; PReLU BlazeBlocks at 64
    (32x32), 128 (16x16) and 128 (8x8) channels; then two branches, each a
    stride-2 block and blocks at 4x4, a stride-2 block and blocks at 2x2,
    and a 2x2 VALID conv (the contour and iris heads).  At 4 blocks per
    stage: 667,044 fp32 parameters, 2.67 MB, the size of the 2,640,568 B
    ``iris_landmark.tflite``.  The heads' biases put the contour inside the
    crop ([12, 52] px) and the iris as a centre point with four points
    5 px around it.
    """
    g = _Graph(np.random.default_rng(seed))
    inp = g.tensor((1, 64, 64, 3))
    x = g.pad(inp, [[0, 0], [0, 1], [0, 1], [0, 0]])
    x = g.prelu(g.conv(x, 64, 3, stride=2, padding=PADDING_VALID))
    for i, cout in enumerate((64, 128, 128)):
        if i:
            x = g.block(x, cout, stride=2, prelu=True)
        for _ in range(blocks_per_stage):
            x = g.block(x, cout, prelu=True)
    feat = x                                         # 8x8x128
    ctr = g.rng.uniform(29.0, 35.0, 2)
    iris_bias = np.zeros((5, 3), np.float32)
    iris_bias[:, :2] = ctr + np.asarray([[0, 0], [5, 0], [0, -5], [-5, 0],
                                         [0, 5]], np.float32)
    iris_bias[:, 2] = g.rng.uniform(-2.0, 2.0, 5)
    contour_bias = np.zeros((71, 3), np.float32)
    contour_bias[:, :2] = g.rng.uniform(12.0, 52.0, (71, 2))
    contour_bias[:, 2] = g.rng.uniform(-4.0, 4.0, 71)
    outs = []
    for bias in (contour_bias, iris_bias):
        y = feat
        for _ in range(2):                           # 4x4, then 2x2
            y = g.block(y, 128, stride=2, prelu=True)
            for _ in range(blocks_per_stage):
                y = g.block(y, 128, prelu=True)
        y = g.conv(y, bias.size, 2, padding=PADDING_VALID, gain=0.2,
                   bias=bias.reshape(-1))
        shp = np.asarray([1, bias.size], np.int32)
        outs.append(g.op("RESHAPE", [y, g.const(shp)], tuple(shp),
                         new_shape=shp.tolist()))
    return g.ir([inp], outs, f"random iris landmark, seed {seed}")


def face_blendshapes_ir(seed: int = 0, blocks: int = MIXER_BLOCKS
                        ) -> ModelIR:
    """The blendshape MLP-Mixer: ``[1, 146, 2]`` landmarks in image pixels
    -> ``[1, 52]`` coefficients in (0, 1).

    The landmark cloud is centred and scaled to unit variance in the graph
    (MEAN, SUB, SQUARED_DIFFERENCE, RSQRT, MUL: a cloud of one point
    yields NaN, which the pipeline's blendshape stage sanitizes), embedded
    to 64 channels, then ``blocks`` Mixer blocks (layer norm, token MLP
    146 -> 256 -> 146 across a transpose, residual add; layer norm,
    channel MLP 64 -> 320 -> 64, residual add), a layer norm, the mean over
    the 146 tokens and a 64 -> 52 FULLY_CONNECTED with LOGISTIC.  Every
    weight is float16 behind a DEQUANTIZE op.  At 4 blocks: 470,725
    parameters, 0.94 MB in fp16, the size of the 955,312 B
    ``face_blendshapes.tflite``.
    """
    g = _Graph(np.random.default_rng(seed))
    inp = g.tensor((1, 146, 2))
    centre = g.mean(inp, [1])
    x = g.op("SUB", [inp, centre], (1, 146, 2), activation=None)
    var = g.mean(g.op("SQUARED_DIFFERENCE", [inp, centre], (1, 146, 2)),
                 [1, 2])
    x = g.op("MUL", [x, g.op("RSQRT", [var], (1, 1, 1))], (1, 146, 2),
             activation=None)
    x = g.fc(x, 64, bias_std=0.1)
    for _ in range(blocks):
        y = g.transpose(g.layer_norm(x), [0, 2, 1])      # [1, 64, 146]
        y = g.transpose(g.mlp(y, 256), [0, 2, 1])
        x = g.op("ADD", [x, y], g.shape(x), activation=None)
        y = g.mlp(g.layer_norm(x), 320)
        x = g.op("ADD", [x, y], g.shape(x), activation=None)
    x = g.layer_norm(x)
    pooled = g.op("MEAN", [x, g.const(np.asarray(1, np.int32))], (1, 64),
                  keep_dims=False)
    w = g.rng.normal(0.0, 1.5 / np.sqrt(64), (52, 64))
    logits = g.op("FULLY_CONNECTED",
                  [pooled, g.half(w), g.half(g.rng.normal(0, 0.5, 52))],
                  (1, 52), activation=None, keep_num_dims=False)
    out = g.op("LOGISTIC", [logits], (1, 52))
    return g.ir([inp], [out], f"random blendshape MLP-Mixer, seed {seed}")


def _score_bias_tensors(ir: ModelIR) -> list[int]:
    """Tensor indices of the score heads' biases: the CONV_2D ops whose
    outputs feed the [1, 896, 1] concatenation through a RESHAPE."""
    producer = {op.outputs[0]: op for op in ir.ops}
    score_cat = producer[ir.outputs[1]]
    return [producer[producer[t].inputs[0]].inputs[2]
            for t in score_cat.inputs]


def calibrate_score_bias(ir: ModelIR, logits: np.ndarray,
                         per_image: int = 32) -> float:
    """Shifts the detector's score-head biases in place so that, on the
    frames that produced ``logits`` ([B, 896] raw scores of this IR), about
    ``per_image`` anchors per frame pass ``MIN_SCORE`` (logit 0).  The cut
    sits midway between two neighbouring pooled logits, away from any
    candidate.  Returns the shift."""
    pooled = np.sort(np.asarray(logits, np.float64).reshape(-1))[::-1]
    m = per_image * logits.shape[0]
    shift = -0.5 * (pooled[m - 1] + pooled[m])
    for t in _score_bias_tensors(ir):
        ir.tensors[t].data = (ir.tensors[t].data + shift).astype(np.float32)
    return float(shift)


def random_pipeline_models(frames: torch.Tensor, *, seed: int = 0,
                           detector_blocks: int = BLAZEFACE_BLOCKS,
                           mesh_blocks: int = MESH_BLOCKS,
                           per_image: int = 32,
                           iris_blocks: int = IRIS_BLOCKS,
                           mixer_blocks: int = MIXER_BLOCKS) -> tuple:
    """Builds the four networks (detector, mesh, iris and blendshape nets
    from seeds ``seed`` to ``seed + 3``), calibrates the detector's scores
    on ``frames`` ([B, H, W, 3] RGB, on the device the models should run
    on) and returns ``(PipelineModels, detector IR, mesh IR, iris IR,
    blendshape IR)``.  The models also carry the seeded full-width
    MobileFaceNet (``build_mobilefacenet(seed + 4)``)."""
    det_ir = blazeface_back_ir(seed, detector_blocks)
    mesh_ir = face_mesh_ir(seed + 1, mesh_blocks)
    iris_ir = iris_landmark_ir(seed + 2, iris_blocks)
    bs_ir = face_blendshapes_ir(seed + 3, mixer_blocks)
    device = frames.device
    fp32_on_the_card(device)
    det = convert_model(det_ir, name="blazeface-back-random").to(device)
    lbp = letterbox_params(frames.shape[1], frames.shape[2], 256, 256)
    with torch.inference_mode():
        _, raw_scores = det(letterbox_image(frames, lbp))
    calibrate_score_bias(det_ir, raw_scores.reshape(frames.shape[0], -1)
                         .double().cpu().numpy(), per_image)
    models = PipelineModels(
        convert_model(det_ir, name="blazeface-back-random"), "back",
        mesh=convert_model(mesh_ir, name="face-mesh-random"), device=device,
        iris=convert_model(iris_ir, name="iris-random"),
        blendshapes=convert_model(bs_ir, name="blendshapes-random"),
        embedding=build_mobilefacenet(seed + 4))
    return models, det_ir, mesh_ir, iris_ir, bs_ir


def random_raw_detections(seed: int, batch: int, anchors: np.ndarray,
                          input_size: float, valid_per_image: int, *,
                          clusters: int = 12, equal_scores: bool = False
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Seeded raw detector outputs for the postprocess: ``raw_boxes
    [B, A, 16]`` and ``raw_scores [B, A, 1]`` (float32) for ``anchors
    [A, 2]``.

    Per image, ``valid_per_image`` anchors get a passing logit and a box in
    one of ``clusters`` clusters (centre jitter 0.01, size 0.05-0.3, so
    clusters overlap and NMS blends them); their scores are distinct and
    spread over [0.5002, 0.99], at least 2e-4 apart and from MIN_SCORE (so
    two sigmoid implementations a few ulp apart agree on order and
    validity), or all equal with ``equal_scores``.  Two more anchors pass
    the score but have w <= 0 or h <= 0.  The rest get logits in
    [-8, -0.05] and random boxes.
    """
    rng = np.random.default_rng(seed)
    a = anchors.shape[0]
    raw_boxes = rng.normal(0, 20, (batch, a, 16)).astype(np.float32)
    raw_scores = rng.uniform(-8, -0.05, (batch, a, 1)).astype(np.float32)
    nv = min(valid_per_image, a)
    for i in range(batch):
        picks = rng.permutation(a)
        on, degenerate = picks[:nv], picks[nv:nv + 2]
        if equal_scores:
            s = np.full(nv, 0.8)
        else:
            s = 0.5002 + (0.99 - 0.5002) * (rng.permutation(nv) + 0.5) / nv
        raw_scores[i, on, 0] = np.log(s / (1 - s))
        ctr = rng.uniform(0.1, 0.9, (clusters, 2))
        wh = rng.uniform(0.05, 0.3, (clusters, 2))
        c = rng.integers(0, clusters, nv)
        centre = ctr[c] + rng.normal(0, 0.01, (nv, 2))
        size = wh[c] * rng.uniform(0.9, 1.1, (nv, 2))
        kp = centre[:, None, :] + rng.uniform(-0.5, 0.5, (nv, 6, 2)) * \
            size[:, None, :]
        raw_boxes[i, on, 0:2] = (centre - anchors[on]) * input_size
        raw_boxes[i, on, 2:4] = size * input_size
        raw_boxes[i, on, 4:16] = ((kp - anchors[on][:, None, :]) *
                                  input_size).reshape(nv, 12)
        raw_scores[i, degenerate, 0] = 2.0
        raw_boxes[i, degenerate, 2] = -np.abs(raw_boxes[i, degenerate, 2])
    return raw_boxes, raw_scores
