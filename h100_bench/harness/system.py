"""The system under test: ``face_detection_tflite_torch``.

This is the one harness module that imports the port.  It turns the
benchmark's graphs into the port's IR, hands them to the port's public
loaders (``convert_model``, ``PipelineModels``; MobileFaceNet through the
checkpoint loader ``swap_params``) and builds the ``FaceDetector`` a
configuration states.
"""

from __future__ import annotations

import numpy as np

from face_detection_tflite_torch import (FaceDetectionMode,
                                         FaceDetectionModel, FaceDetector,
                                         SegmentationConfig,
                                         SegmentationModel)
from face_detection_tflite_torch.convert.checkpoint import swap_params
from face_detection_tflite_torch.convert.executor import convert_model
from face_detection_tflite_torch.convert.tflite import (ModelIR, OpIR,
                                                        TensorIR)
from face_detection_tflite_torch.kernels import build as _build
from face_detection_tflite_torch.models.embedding import MobileFaceNet
from face_detection_tflite_torch.pipeline import graphs
from face_detection_tflite_torch.pipeline.programs import PipelineModels

__all__ = ["make_detector", "mode", "to_ir", "capture_now", "load_kernels"]

capture_now = graphs.capture_now
#: Builds the hand-written kernels where the checkout has none yet
#: (``kernels/_build/`` inside it), then loads them.
load_kernels = _build.load


def to_ir(graph) -> ModelIR:
    """The benchmark's graph in the port's IR (TFLite's option names, the
    shape operands as constant tensors)."""
    tensors = [TensorIR(i, f"t{i}", t.shape,
                        np.float32 if t.data is None else t.data.dtype.type,
                        t.data) for i, t in enumerate(graph.tensors)]

    def const(arr) -> int:
        arr = np.asarray(arr, np.int32)
        tensors.append(TensorIR(len(tensors), f"t{len(tensors)}",
                                arr.shape, np.int32, arr))
        return len(tensors) - 1

    ops = []
    for op in graph.ops:
        o, inputs = dict(op.options), list(op.inputs)
        if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            s = o.pop("stride")
            o.update(stride_w=s, stride_h=s, dilation_w=1, dilation_h=1)
            if op.name == "DEPTHWISE_CONV_2D":
                o["depth_multiplier"] = 1
        elif op.name == "MAX_POOL_2D":
            o = {"padding": 1, "stride_w": o["stride"],
                 "stride_h": o["stride"], "filter_w": o["filter"],
                 "filter_h": o["filter"], "activation": None}
        elif op.name == "AVERAGE_POOL_2D":
            (fh, fw), (sh, sw) = o["filter"], o["stride"]
            o = {"padding": o["padding"], "stride_h": sh, "stride_w": sw,
                 "filter_h": fh, "filter_w": fw, "activation": None}
        elif op.name == "RESIZE_BILINEAR":
            inputs.append(const(o.pop("size")))
        elif op.name in ("TRANSPOSE_CONV",
                         "CUSTOM:Convolution2DTransposeBias"):
            s = o.pop("stride")
            o.update(stride_h=s, stride_w=s)
            if op.name == "TRANSPOSE_CONV":
                inputs.insert(0, const(o.pop("output_shape")))
                o["activation"] = None
        elif op.name == "RESHAPE":
            inputs.append(const(o["new_shape"]))
        elif op.name == "MEAN":
            inputs.append(const(o.pop("axes")))
        elif op.name == "TRANSPOSE":
            inputs.append(const(o.pop("perm")))
        elif op.name == "FULLY_CONNECTED":
            o["activation"] = None
        elif op.name == "GELU":
            o["approximate"] = False
        elif op.name in ("ADD", "SUB", "MUL", "CONCATENATION"):
            o.setdefault("activation", None)
        ops.append(OpIR(op.name, inputs, list(op.outputs), o))
    return ModelIR(tensors, ops, list(graph.inputs), list(graph.outputs),
                   graph.description)


def mode(config: dict) -> FaceDetectionMode:
    """The pipeline depth ``config`` states (``mode``, a
    ``FaceDetectionMode`` name)."""
    return FaceDetectionMode[config["mode"]]


def make_detector(nets: dict, config: dict, device) -> FaceDetector:
    """The ``FaceDetector`` of ``config`` on the benchmark's networks: each
    role's graph converted to the port's IR, or, for a parameter dict
    (``embedding``), MobileFaceNet loaded from it as a checkpoint.  A
    ``segmentation`` role goes in as ``PipelineModels(segmentation=...)``
    with the configuration's ``segmentation`` block (``model``, a
    ``SegmentationModel`` name; ``mask_dtype``; ``precision``) as its
    ``SegmentationConfig``."""
    models = {}
    for role, net in nets.items():
        if isinstance(net, dict):
            models[role] = swap_params(MobileFaceNet(), net,
                                       name=f"{role}-seeded")
        else:
            models[role] = convert_model(to_ir(net), name=role)
    variant = FaceDetectionModel[config["detector_model"]]
    detector = models.pop("detector")
    seg = config.get("segmentation")
    seg_config = None if seg is None else SegmentationConfig(
        model=SegmentationModel[seg["model"]], mask_dtype=seg["mask_dtype"],
        precision=seg["precision"])
    return FaceDetector(variant, max_faces=config["max_faces"],
                        precision=config["precision"],
                        embed_in_full="embedding" in models,
                        allow_untrained_embeddings=True, device=device,
                        segmentation_config=seg_config,
                        models=PipelineModels(detector, variant.value,
                                              device=device, **models))
