"""The TFLite-form graph of ``tests/iresnet_reference.py`` in the port's
IR, for the CPU tests and ``chip_smoke.py``.  Imports neither ``jax``
nor the JAX package."""

import numpy as np

from face_detection_tflite_torch.convert.tflite import (ModelIR, OpIR,
                                                        TensorIR)


def to_ir(graph) -> ModelIR:
    """``graph`` (an ``iresnet_reference.Graph``) in the port's IR."""
    tensors = [TensorIR(i, f"t{i}", t.shape,
                        np.float32 if t.data is None else t.data.dtype.type,
                        t.data) for i, t in enumerate(graph.tensors)]
    ops = [OpIR(op.name, list(op.inputs), list(op.outputs),
                dict(op.options)) for op in graph.ops]
    return ModelIR(tensors, ops, list(graph.inputs), list(graph.outputs),
                   "iresnet")
