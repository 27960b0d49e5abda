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

import dataclasses

import numpy as np
import torch

from ..convert.executor import convert_model, fp32_on_the_card
from ..convert.tflite import (PADDING_SAME, PADDING_VALID, ModelIR, OpIR,
                              TensorIR)
from ..ops.letterbox import letterbox_image, letterbox_params
from ..pipeline.programs import PipelineModels
from .embedding import build_mobilefacenet

__all__ = ["blazeface_back_ir", "blazeface_front_ir",
           "blazeface_full_range_ir", "sparse_detector_ir", "face_mesh_ir",
           "iris_landmark_ir", "face_blendshapes_ir", "selfie_segmenter_ir",
           "selfie_multiclass_ir", "segmenter_ir", "calibrate_score_bias",
           "calibrated_detector_ir", "random_pipeline_models",
           "random_raw_detections", "BLAZEFACE_BLOCKS", "FRONT_BLOCKS",
           "FULL_RANGE_BLOCKS", "MESH_BLOCKS", "IRIS_BLOCKS", "MIXER_BLOCKS",
           "DETECTORS"]

#: Full depth: non-strided blocks per stage of the published topologies,
#: and Mixer blocks of the blendshape net.
BLAZEFACE_BLOCKS = 7
FRONT_BLOCKS = 4
FULL_RANGE_BLOCKS = 4
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

    def __init__(self, rng: np.random.Generator, fp16: bool = False):
        self.rng = rng
        #: Store the layers' filters (and their zero biases) as float16
        #: behind DEQUANTIZE, the form of the fp16 ``.tflite`` files.
        self.fp16 = fp16
        self.tensors: list[TensorIR] = []
        self.ops: list[OpIR] = []

    def tensor(self, shape, data=None, dtype=np.float32) -> int:
        i = len(self.tensors)
        self.tensors.append(TensorIR(i, f"t{i}", tuple(int(d) for d in shape),
                                     dtype, data))
        return i

    def const(self, arr: np.ndarray) -> int:
        return self.tensor(arr.shape, arr, arr.dtype.type)

    def weight(self, arr: np.ndarray) -> int:
        """A layer's constant: float16 behind DEQUANTIZE in an fp16 graph,
        else float32."""
        return self.half(arr) if self.fp16 else self.const(
            np.asarray(arr, np.float32))

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
             gain=1.0, bias=None, weights=None, prune=False):
        _, h, w, cin = self.shape(x)
        wt = self.rng.normal(0.0, gain * np.sqrt(2.0 / (k * k * cin)),
                             (cout, k, k, cin)).astype(np.float32)
        if weights == "zero_sum":
            wt -= wt.mean(axis=(1, 2, 3), keepdims=True)
        elif weights == "positive":
            wt = np.abs(wt)
        if prune:
            # Zero the smaller half of each output channel's weights (the
            # full-range detector's sparse filters).
            cut = np.median(np.abs(wt), axis=(1, 2, 3), keepdims=True)
            wt = np.where(np.abs(wt) > cut, wt, 0.0).astype(np.float32)
        # A given bias (a head's, which calibration shifts) stays float32.
        b = (self.weight(np.zeros(cout, np.float32)) if bias is None
             else self.const(np.asarray(bias, np.float32)))
        if padding == PADDING_SAME:
            oh, ow = -(-h // stride), -(-w // stride)
        else:
            oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
        # A zero-sum filter stays float32: rounded to float16 its sum
        # would no longer be 0.
        return self.op("CONV_2D", [x, self.const(wt) if weights == "zero_sum"
                                   else self.weight(wt), b],
                       (1, oh, ow, cout), padding=padding, stride_w=stride,
                       stride_h=stride, activation=act, dilation_w=1,
                       dilation_h=1)

    def depthwise(self, x, stride, k=3, explicit_pad=True, act=None):
        _, h, w, c = self.shape(x)
        if stride == 2 and explicit_pad:
            # Explicit (0, 2) spatial pad then VALID, as the exported graphs do.
            x = self.pad(x, [[0, 0], [0, k - 1], [0, k - 1], [0, 0]])
            h, w = h + k - 1, w + k - 1
            padding, oh, ow = (PADDING_VALID, (h - k) // 2 + 1,
                               (w - k) // 2 + 1)
        else:
            padding, oh, ow = PADDING_SAME, -(-h // stride), -(-w // stride)
        wt = self.rng.normal(0.0, np.sqrt(1.0 / (k * k)),
                             (1, k, k, c)).astype(np.float32)
        return self.op("DEPTHWISE_CONV_2D",
                       [x, self.weight(wt),
                        self.weight(np.zeros(c, np.float32))],
                       (1, oh, ow, c), padding=padding, stride_w=stride,
                       stride_h=stride, depth_multiplier=1, activation=act,
                       dilation_w=1, dilation_h=1)

    def pad(self, x, pads):
        shp = [d + a + b for d, (a, b) in zip(self.shape(x), pads)]
        return self.op("PAD", [x, self.const(np.asarray(pads, np.int32))], shp)

    def prelu(self, x):
        c = self.shape(x)[3]
        alpha = self.rng.uniform(0.1, 0.3, (1, 1, c)).astype(np.float32)
        return self.op("PRELU", [x, self.const(alpha)], self.shape(x))

    def block(self, x, cout, stride=1, prelu=False, prune=False):
        """BlazeBlock: dw 3x3 -> pw 1x1 (+ residual) -> ReLU / PReLU."""
        _, h, w, cin = self.shape(x)
        y = self.conv(self.depthwise(x, stride), cout, 1, gain=_RES_GAIN,
                      prune=prune)
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

    # -- segmenter layers (MobileNetV3 encoder, attention decoder) ----------

    def hard_swish(self, x):
        return self.op("HARD_SWISH", [x], self.shape(x))

    def scalar(self, v: float) -> int:
        return self.const(np.asarray([v], np.float32))

    def global_pool(self, x):
        """AVERAGE_POOL_2D over the whole map: [1, 1, 1, C]."""
        _, h, w, c = self.shape(x)
        return self.op("AVERAGE_POOL_2D", [x], (1, 1, 1, c),
                       padding=PADDING_VALID, stride_w=w, stride_h=h,
                       filter_w=w, filter_h=h, activation=None)

    def hard_sigmoid(self, x):
        """relu6(x + 3) / 6, as TFLite holds it: ADD with a fused RELU6,
        then MUL."""
        y = self.op("ADD", [x, self.scalar(3.0)], self.shape(x),
                    activation="RELU6")
        return self.op("MUL", [y, self.scalar(1.0 / 6.0)], self.shape(x),
                       activation=None)

    def squeeze_excite(self, x, squeeze):
        """x * hard_sigmoid(1x1(relu(1x1(avg_pool(x)))))."""
        c = self.shape(x)[3]
        g = self.conv(self.global_pool(x), squeeze, 1, act="RELU")
        g = self.hard_sigmoid(self.conv(g, c, 1))
        return self.op("MUL", [x, g], self.shape(x), activation=None)

    def bneck(self, x, expand, cout, k=3, stride=1, se=False, hs=False):
        """MobileNetV3 bottleneck: 1x1 expand -> depthwise k x k (SAME) ->
        (squeeze-excite) -> 1x1 project (+ residual where the shape
        stays), hard-swish or ReLU after the expand and the depthwise."""
        cin = self.shape(x)[3]

        def act(t):
            return self.hard_swish(t) if hs else self.op(
                "RELU", [t], self.shape(t))
        y = act(self.conv(x, expand, 1)) if expand != cin else x
        y = act(self.depthwise(y, stride, k=k, explicit_pad=False))
        if se:
            y = self.squeeze_excite(y, max(8, expand // 4))
        y = self.conv(y, cout, 1, gain=_RES_GAIN if stride == 1 and
                      cout == cin else 1.0)
        if stride == 1 and cout == cin:
            y = self.op("ADD", [x, y], self.shape(y), activation=None)
        return y

    def resize(self, x, hw):
        """RESIZE_BILINEAR to ``hw`` with half-pixel centres (TF2's
        ``tf.image.resize``)."""
        return self.op("RESIZE_BILINEAR",
                       [x, self.const(np.asarray(hw, np.int32))],
                       (1, *hw, self.shape(x)[3]), align_corners=False,
                       half_pixel_centers=True)

    def transpose_conv(self, x, cout, k=2, stride=2, custom=False,
                       bias=None, gain=1.0):
        """A k x k stride-s SAME transposed conv to ``cout`` channels:
        MediaPipe's ``Convolution2DTransposeBias`` custom op (x, filter,
        bias) or the builtin TRANSPOSE_CONV (output shape, filter, x,
        bias).  TFLite filter layout [O, kh, kw, I]."""
        _, h, w, cin = self.shape(x)
        out = (1, h * stride, w * stride, cout)
        wt = self.rng.normal(0.0, gain * np.sqrt(2.0 * stride * stride /
                                                 (k * k * cin)),
                             (cout, k, k, cin)).astype(np.float32)
        b = self.weight(np.zeros(cout, np.float32) if bias is None
                        else np.asarray(bias, np.float32))
        if custom:
            return self.op("CUSTOM:Convolution2DTransposeBias",
                           [x, self.weight(wt), b], out,
                           padding=PADDING_SAME, stride_w=stride,
                           stride_h=stride)
        return self.op("TRANSPOSE_CONV",
                       [self.const(np.asarray(out, np.int32)),
                        self.weight(wt), x, b], out, padding=PADDING_SAME,
                       stride_w=stride, stride_h=stride, activation=None)

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


def _box_bias(input_size: int) -> np.ndarray:
    """:data:`_BOX_BIAS` in ``input_size`` px units."""
    return (_BOX_BIAS * np.float32(input_size / 256.0)).astype(np.float32)


def _detection_heads(g: _Graph, layers, input_size: int, out_anchors: int,
                     prune: bool = False):
    """Score and box heads of ``layers`` ((feature, anchors per cell),
    ...), concatenated where there are several, in
    ``generate_anchors`` order: ``[1, A, 16]`` and ``[1, A, 1]``."""
    scores, boxes = [], []
    for feat, anchors in layers:
        scores.append(g.head(feat, 1, 0.5, np.zeros(anchors, np.float32),
                             weights="positive"))
        boxes.append(g.head(feat, 16, 0.25,
                            np.tile(_box_bias(input_size), anchors)))
    if len(layers) == 1:
        return boxes[0], scores[0]
    box = g.op("CONCATENATION", boxes, (1, out_anchors, 16), axis=1,
               activation=None)
    score = g.op("CONCATENATION", scores, (1, out_anchors, 1), axis=1,
                 activation=None)
    return box, score


def blazeface_front_ir(seed: int = 0, blocks_per_stage: int = FRONT_BLOCKS
                       ) -> ModelIR:
    """The BlazeFace front-camera detector (128 px, 896 anchors in
    ``generate_anchors(SSD_FRONT)`` order); SHORT_RANGE runs the same graph
    (its file is the same size, 229,032 B).

    ``blazeface.py`` with ``back_model=False`` in hollance/BlazeFace-PyTorch:
    128x128x3 in; 5x5/2 conv to 24 ch; BlazeBlocks to 24, 28, 32 (/2), 36,
    42, 48 (/2), 56, 64, 72, 80 and 88 channels at 16x16; a stride-2 block
    to 8x8x96 and ``blocks_per_stage`` blocks at 96; 1x1 heads of 2 scores
    + 32 box values at 16x16 and 6 + 96 at 8x8.  At 4 blocks: 101,390
    weights, float16 behind DEQUANTIZE (the stem's zero-sum filter and the
    heads' biases, which calibration shifts, float32), 0.20 MB in fp16,
    the size of the published files."""
    g = _Graph(np.random.default_rng(seed), fp16=True)
    inp = g.tensor((1, 128, 128, 3))
    x = g.pad(inp, [[0, 0], [1, 2], [1, 2], [0, 0]])
    x = g.conv(x, 24, 5, stride=2, padding=PADDING_VALID, act="RELU",
               weights="zero_sum")                   # 64x64x24
    for cout, stride in ((24, 1), (28, 1), (32, 2), (36, 1), (42, 1),
                         (48, 2), (56, 1), (64, 1), (72, 1), (80, 1),
                         (88, 1)):
        x = g.block(x, cout, stride)
    x16 = x                                          # 16x16x88
    x = g.block(x16, 96, stride=2)                   # 8x8x96
    for _ in range(blocks_per_stage):
        x = g.block(x, 96)
    box, score = _detection_heads(g, ((x16, 2), (x, 6)), 128, 896)
    return g.ir([inp], [box, score], f"random BlazeFace front, seed {seed}")


def blazeface_full_range_ir(seed: int = 0,
                            blocks_per_stage: int = FULL_RANGE_BLOCKS
                            ) -> ModelIR:
    """The full-range BlazeFace detector (192 px, 2304 anchors on one 48x48
    stride-4 layer, ``generate_anchors(SSD_FULL)`` order).

    No width table of the published graph is cited here, so the widths are
    this port's own, sized to the 1,083,984 B
    ``face_detection_full_range.tflite`` read as float32 weights: a
    BlazeFace backbone (5x5/2 conv to 24 ch at 96x96; BlazeBlocks at 24,
    then 32 at 48x48, 80 at 24x24 and 192 at 12x12, ``blocks_per_stage``
    a stage) and a top-down path back to 48x48: a 1x1 conv to 80 ch and a
    RESIZE_BILINEAR to 24x24 added to the 24x24 features, blocks, a 2x2
    stride-2 TRANSPOSE_CONV to 32 ch added to the 48x48 features, blocks,
    then 1x1 heads of 1 score and 16 box values a cell.  The pointwise
    filters of the blocks from 48x48 on keep only the larger half of each
    output channel's weights (zeros elsewhere), the filters that
    :func:`sparse_detector_ir` stores in TFLite's sparse format for
    FULL_SPARSE.  At 4 blocks a stage: 259,649 weights, 1.04 MB in fp32.
    """
    g = _Graph(np.random.default_rng(seed))
    inp = g.tensor((1, 192, 192, 3))
    x = g.pad(inp, [[0, 0], [1, 2], [1, 2], [0, 0]])
    x = g.conv(x, 24, 5, stride=2, padding=PADDING_VALID, act="RELU",
               weights="zero_sum")                   # 96x96x24
    for _ in range(blocks_per_stage):
        x = g.block(x, 24)
    feats = []
    for cout in (32, 80, 192):                       # 48, 24, 12
        x = g.block(x, cout, stride=2, prune=True)
        for _ in range(blocks_per_stage):
            x = g.block(x, cout, prune=True)
        feats.append(x)
    x48, x24, x12 = feats
    y = g.resize(g.conv(x12, 80, 1, act="RELU"), (24, 24))
    y = g.op("ADD", [y, x24], g.shape(y), activation="RELU")
    for _ in range(blocks_per_stage // 2):
        y = g.block(y, 80, prune=True)
    y = g.transpose_conv(y, 32)                      # 48x48x32
    y = g.op("ADD", [y, x48], g.shape(y), activation="RELU")
    for _ in range(blocks_per_stage // 2):
        y = g.block(y, 32, prune=True)
    box, score = _detection_heads(g, ((y, 1),), 192, 2304)
    return g.ir([inp], [box, score],
                f"random BlazeFace full range, seed {seed}")


def sparse_detector_ir(ir: ModelIR) -> ModelIR:
    """FULL_SPARSE's form of a full-range IR: every CONV_2D filter with
    zeros (the pruned ones, :func:`blazeface_full_range_ir`) stored in
    TFLite's sparse format (dimensions O, kh, kw dense, I compressed
    sparse row) behind a DENSIFY op at the head of the graph, as the
    sparse ``.tflite`` file holds its filters.  Densified, the weights are
    the dense IR's, so both compute the same function."""
    tensors = [dataclasses.replace(t) for t in ir.tensors]
    ops = [OpIR(op.name, list(op.inputs), list(op.outputs),
                dict(op.options)) for op in ir.ops]
    densify_ops = []
    for op in ops:
        if op.name != "CONV_2D":
            continue
        t = tensors[op.inputs[1]]
        if t.data is None or not (t.data == 0).any():
            continue
        flat = t.data.reshape(-1, t.shape[3])
        nz = flat != 0
        t.sparsity = {
            "traversal_order": [0, 1, 2, 3], "block_map": [],
            "dim_metadata": [{"format": 0, "dense_size": d}
                             for d in t.shape[:3]] + [{
                "format": 1,
                "array_segments": np.concatenate(
                    [[0], np.cumsum(nz.sum(axis=1))]).astype(np.int64),
                "array_indices": np.nonzero(nz)[1].astype(np.int64)}]}
        t.data = flat[nz].astype(np.float32)
        dense = len(tensors)
        tensors.append(TensorIR(dense, f"{t.name}_dense", t.shape,
                                np.float32, None))
        densify_ops.append(OpIR("DENSIFY", [t.index], [dense], {}))
        op.inputs[1] = dense
    return ModelIR(tensors, densify_ops + ops, list(ir.inputs),
                   list(ir.outputs), ir.description + ", sparse filters")


#: The segmenters' encoder stages (MobileNetV3 bottlenecks: expansion,
#: output channels, depthwise kernel, stride of the first block,
#: squeeze-excite, hard-swish, blocks) after a 3x3/2 stem to ``stem``
#: channels; each stage's last output is a skip of the decoder.
SEGMENTER = {"stem": 16, "stages": (
    (16, 16, 3, 2, True, False, 1), (72, 24, 3, 2, False, False, 2),
    (96, 40, 5, 2, True, True, 3), (128, 48, 5, 2, True, True, 2))}
MULTICLASS_SEGMENTER = {"stem": 24, "stages": (
    (48, 32, 3, 2, True, False, 2), (144, 64, 3, 2, False, False, 3),
    (384, 160, 5, 2, True, True, 4), (1024, 448, 5, 2, True, True, 5))}


def _segmenter_ir(seed: int, in_hw: tuple[int, int], classes: int,
                  spec: dict, description: str) -> ModelIR:
    """The selfie segmenters' encoder-decoder (MediaPipe's Selfie
    Segmentation model card: a MobileNetV3-style encoder and a decoder
    that upsamples with attention on the skips), fp16 weights behind
    DEQUANTIZE.

    ``in_hw`` x 3 in; a 3x3/2 conv with hard-swish; the encoder stages of
    ``spec`` (stride 2 each, down to 1/32); then per skip, deepest first:
    a 1x1 conv with ReLU to the skip's width, RESIZE_BILINEAR to the
    skip's size, the skip gated by the sigmoid of a 1x1 conv of the
    upsampled map's global AVERAGE_POOL_2D (squeeze-excite pooling and
    MUL), ADD, and a bottleneck; a 2x2 stride-2
    ``Convolution2DTransposeBias`` to ``classes`` channels at the input's
    size; for one class a LOGISTIC (the person probability), else the
    class logits."""
    g = _Graph(np.random.default_rng(seed), fp16=True)
    inp = g.tensor((1, *in_hw, 3))
    x = g.hard_swish(g.conv(inp, spec["stem"], 3, stride=2))
    skips = [x]
    for expand, cout, k, stride, se, hs, blocks in spec["stages"]:
        for b in range(blocks):
            x = g.bneck(x, expand, cout, k, stride if b == 0 else 1, se, hs)
        skips.append(x)
    d = skips.pop()
    for skip in reversed(skips):
        _, h, w, c = g.shape(skip)
        d = g.resize(g.conv(d, c, 1, act="RELU"), (h, w))
        gate = g.op("LOGISTIC", [g.conv(g.global_pool(d), c, 1)],
                    (1, 1, 1, c))
        d = g.op("ADD", [d, g.op("MUL", [skip, gate], g.shape(skip),
                                 activation=None)], g.shape(d),
                 activation=None)
        d = g.bneck(d, 2 * c, c)
    out = g.transpose_conv(d, classes, custom=True, gain=0.5)
    if classes == 1:
        out = g.op("LOGISTIC", [out], g.shape(out))
    return g.ir([inp], [out], f"{description}, seed {seed}")


def selfie_segmenter_ir(seed: int = 0, landscape: bool = False,
                        spec: dict = SEGMENTER) -> ModelIR:
    """The general (256x256) or landscape (144x256) selfie segmenter:
    ``[1, H, W, 1]`` person probability.  119,413 fp16 weights (0.24 MB,
    the size of the 249,537 B and 250,177 B published files)."""
    hw = (144, 256) if landscape else (256, 256)
    return _segmenter_ir(seed, hw, 1, spec,
                         "random selfie segmenter" +
                         (" landscape" if landscape else ""))


def selfie_multiclass_ir(seed: int = 0,
                         spec: dict = MULTICLASS_SEGMENTER) -> ModelIR:
    """The multiclass selfie segmenter (256x256): ``[1, 256, 256, 6]``
    logits of background, hair, body skin, face skin, clothes and other.
    Wider and deeper than the binary ones: 8,168,956 fp16 weights (16.3 MB,
    the size of the published ~16 MB file)."""
    return _segmenter_ir(seed, (256, 256), 6, spec,
                         "random selfie multiclass segmenter")


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
    outputs reach the [1, A, 1] scores through a RESHAPE (and the
    concatenation of several heads)."""
    producer = {op.outputs[0]: op for op in ir.ops}
    out = producer[ir.outputs[1]]
    reshapes = ([producer[t] for t in out.inputs]
                if out.name == "CONCATENATION" else [out])
    return [producer[r.inputs[0]].inputs[2] for r in reshapes]


def calibrate_score_bias(ir: ModelIR, logits: np.ndarray,
                         per_image: int = 32) -> float:
    """Shifts the detector's score-head biases in place so that, on the
    frames that produced ``logits`` ([B, A] raw scores of this IR), about
    ``per_image`` anchors per frame pass ``MIN_SCORE`` (logit 0).  The cut
    sits midway between two neighbouring pooled logits, away from any
    candidate.  Returns the shift."""
    pooled = np.sort(np.asarray(logits, np.float64).reshape(-1))[::-1]
    m = per_image * logits.shape[0]
    shift = -0.5 * (pooled[m - 1] + pooled[m])
    for t in _score_bias_tensors(ir):
        ir.tensors[t].data = (ir.tensors[t].data + shift).astype(np.float32)
    return float(shift)


#: Per ``FaceDetectionModel`` value: the function that builds the IR, input
#: size, default depth and seed offset.  SHORT_RANGE runs FRONT_CAMERA's
#: graph with a seed of its own; FULL_SPARSE carries FULL's weights.
DETECTORS = {"back": (blazeface_back_ir, 256, BLAZEFACE_BLOCKS, 0),
             "front": (blazeface_front_ir, 128, FRONT_BLOCKS, 0),
             "short_range": (blazeface_front_ir, 128, FRONT_BLOCKS, 7),
             "full": (blazeface_full_range_ir, 192, FULL_RANGE_BLOCKS, 0),
             "full_sparse": (blazeface_full_range_ir, 192,
                             FULL_RANGE_BLOCKS, 0)}


def segmenter_ir(kind: str, seed: int = 0, spec: dict | None = None
                 ) -> ModelIR:
    """The seeded segmenter of ``SegmentationModel`` value ``kind``
    ("general", "landscape" or "multiclass"), at the published size or
    with the encoder ``spec`` (the tests' narrow ones)."""
    if kind == "multiclass":
        return selfie_multiclass_ir(seed, spec or MULTICLASS_SEGMENTER)
    if kind not in ("general", "landscape"):
        raise ValueError(f"unknown segmenter {kind!r}")
    return selfie_segmenter_ir(seed, kind == "landscape", spec or SEGMENTER)


def calibrated_detector_ir(variant: str, frames: torch.Tensor, seed: int,
                           blocks: int | None = None,
                           per_image: int = 32) -> ModelIR:
    """The seeded detector of ``variant`` (a ``FaceDetectionModel`` value;
    seed ``seed`` plus the variant's offset in :data:`DETECTORS`) with its
    score heads calibrated on ``frames`` (:func:`calibrate_score_bias`,
    on the device the frames live on).  FULL_SPARSE is the calibrated
    full-range IR with its pruned filters stored sparse
    (:func:`sparse_detector_ir`), so it carries FULL's weights."""
    build, size, default_blocks, offset = DETECTORS[variant]
    ir = build(seed + offset, default_blocks if blocks is None else blocks)
    device = frames.device
    fp32_on_the_card(device)
    det = convert_model(ir).to(device)
    lbp = letterbox_params(frames.shape[1], frames.shape[2], size, size)
    with torch.inference_mode():
        _, raw_scores = det(letterbox_image(frames, lbp))
    calibrate_score_bias(ir, raw_scores.reshape(frames.shape[0], -1)
                         .double().cpu().numpy(), per_image)
    return sparse_detector_ir(ir) if variant == "full_sparse" else ir


def random_pipeline_models(frames: torch.Tensor, *, seed: int = 0,
                           variant: str = "back",
                           detector_blocks: int | None = None,
                           mesh_blocks: int = MESH_BLOCKS,
                           per_image: int = 32,
                           iris_blocks: int = IRIS_BLOCKS,
                           mixer_blocks: int = MIXER_BLOCKS,
                           segmenter: str | None = None,
                           segmenter_spec: dict | None = None) -> tuple:
    """Builds the four networks (the ``variant`` detector, mesh, iris and
    blendshape nets from seeds ``seed`` to ``seed + 3``), calibrates the
    detector's scores on ``frames`` ([B, H, W, 3] RGB, on the device the
    models should run on) and returns ``(PipelineModels, detector IR, mesh
    IR, iris IR, blendshape IR)``.  The models also carry the seeded
    full-width MobileFaceNet (``build_mobilefacenet(seed + 4)``).  With
    ``segmenter`` ("general", "landscape" or "multiclass") they carry that
    segmenter too (seed ``seed + 5``, encoder ``segmenter_spec`` where
    given), and its IR ends the tuple."""
    det_ir = calibrated_detector_ir(variant, frames, seed, detector_blocks,
                                    per_image)
    mesh_ir = face_mesh_ir(seed + 1, mesh_blocks)
    iris_ir = iris_landmark_ir(seed + 2, iris_blocks)
    bs_ir = face_blendshapes_ir(seed + 3, mixer_blocks)
    seg_ir = (segmenter_ir(segmenter, seed + 5, segmenter_spec)
              if segmenter else None)
    models = PipelineModels(
        convert_model(det_ir, name=f"blazeface-{variant}-random"), variant,
        mesh=convert_model(mesh_ir, name="face-mesh-random"),
        device=frames.device,
        iris=convert_model(iris_ir, name="iris-random"),
        blendshapes=convert_model(bs_ir, name="blendshapes-random"),
        embedding=build_mobilefacenet(seed + 4),
        segmentation=(convert_model(seg_ir, name=f"segmenter-{segmenter}"
                                    "-random") if seg_ir else None))
    irs = (det_ir, mesh_ir, iris_ir, bs_ir) + ((seg_ir,) if seg_ir else ())
    return (models, *irs)


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
