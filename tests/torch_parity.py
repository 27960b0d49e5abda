"""Shared fixtures of the tests that hold the PyTorch port against the JAX
package: the same IR and the same numpy inputs reach both."""

from __future__ import annotations

import numpy as np

from face_detection_tflite_torch.convert import executor as t_exec
from face_detection_tflite_tpu.convert import executor as j_exec
from face_detection_tflite_tpu.convert import tflite as j_tflite


def jax_ir(ir):
    """The port's ModelIR copied field by field into the JAX package's."""
    return j_tflite.ModelIR(
        tensors=[j_tflite.TensorIR(t.index, t.name, t.shape, t.dtype, t.data,
                                   t.sparsity, t.quant) for t in ir.tensors],
        ops=[j_tflite.OpIR(op.name, list(op.inputs), list(op.outputs),
                           dict(op.options)) for op in ir.ops],
        inputs=list(ir.inputs), outputs=list(ir.outputs),
        description=ir.description)


def both_models(ir):
    """(JAX ConvertedModel, port ConvertedModel carrying the JAX params)."""
    jm = j_exec.convert_model(jax_ir(ir))
    tm = t_exec.convert_model(ir)
    tm.load_state_dict(t_exec.params_from_jax(
        ir, {k: np.asarray(v) for k, v in jm.params.items()}))
    return jm, tm


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))

