"""Seeded full-width BlazeFace-back and FaceMesh graphs, built in numpy.

The trained MediaPipe ``.tflite`` files are not part of the repository, so
the port's main path runs the published topologies with seeded weights
instead.  Each network is a :class:`~..convert.tflite.ModelIR` — the IR
that ``parse_tflite`` produces — made of the op mix the real files use
(CONV_2D, DEPTHWISE_CONV_2D, ADD with a fused ReLU, PAD, MAX_POOL_2D,
PRELU, RESHAPE, CONCATENATION), at the published widths and resolutions.
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

from ..convert.executor import convert_model
from ..convert.tflite import (PADDING_SAME, PADDING_VALID, ModelIR, OpIR,
                              TensorIR)
from ..ops.letterbox import letterbox_image, letterbox_params
from ..pipeline.programs import PipelineModels

__all__ = ["blazeface_back_ir", "face_mesh_ir", "calibrate_score_bias",
           "random_pipeline_models", "BLAZEFACE_BLOCKS", "MESH_BLOCKS"]

#: Full depth: non-strided blocks per stage of the published topologies.
BLAZEFACE_BLOCKS = 7
MESH_BLOCKS = 2

# Residual-branch gain: keeps activations O(1) over ~30 residual blocks.
_RES_GAIN = 0.35

# Box-head bias in 256-px detector-input units: (cx, cy, w, h) then the six
# keypoints (left eye, right eye, nose tip, mouth, left and right tragion).
_BOX_BIAS = np.asarray([0, 0, 44, 44,
                        -9, -8, 9, -8, 0, 2, 0, 12, -20, -4, 20, -4],
                       np.float32)


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
    """The 468-point FaceMesh landmark net (192 px) with its presence head."""
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
    lm_bias[:, 2] = g.rng.uniform(-10.0, 10.0, 468)
    lm = g.conv(y, 1404, 3, padding=PADDING_VALID, gain=0.5,
                bias=lm_bias.reshape(-1))
    p = g.block(feat, 128, stride=2, prelu=True)
    presence = g.conv(p, 1, 3, padding=PADDING_VALID, gain=0.05,
                      bias=np.asarray([3.0], np.float32))
    return g.ir([inp], [lm, presence], f"random FaceMesh, seed {seed}")


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
                           per_image: int = 32
                           ) -> tuple[PipelineModels, ModelIR, ModelIR]:
    """Builds both networks, calibrates the detector's scores on
    ``frames`` ([B, H, W, 3] RGB, on the device the models should run on)
    and returns ``(PipelineModels, detector IR, mesh IR)``."""
    det_ir = blazeface_back_ir(seed, detector_blocks)
    mesh_ir = face_mesh_ir(seed + 1, mesh_blocks)
    device = frames.device
    det = convert_model(det_ir, name="blazeface-back-random").to(device)
    lbp = letterbox_params(frames.shape[1], frames.shape[2], 256, 256)
    with torch.inference_mode():
        _, raw_scores = det(letterbox_image(frames, lbp))
    calibrate_score_bias(det_ir, raw_scores.reshape(frames.shape[0], -1)
                         .double().cpu().numpy(), per_image)
    models = PipelineModels(
        convert_model(det_ir, name="blazeface-back-random"), "back",
        mesh=convert_model(mesh_ir, name="face-mesh-random"), device=device)
    return models, det_ir, mesh_ir
