"""Shared fixtures of the tests that hold the PyTorch port against the JAX
package: the same IR and the same numpy inputs reach both."""

from __future__ import annotations

import numpy as np
import torch

from face_detection_tflite_torch.convert import executor as t_exec
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_tpu.convert import executor as j_exec
from face_detection_tflite_tpu.convert import tflite as j_tflite
from face_detection_tflite_tpu.models import embedding as j_embedding
from face_detection_tflite_tpu.pipeline import programs as j_programs

#: The small pipeline setup: two 96x144 frames, a 4-face slab, one block
#: per stage of every seeded network, about 12 candidates per frame.
H, W, B, MAX_FACES = 96, 144, 2, 4
SEED = 11


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


#: A narrow segmenter encoder (every op kind of the published one: the
#: hard-swish, squeeze-excite and ReLU bottlenecks of both kernel sizes)
#: for the CPU tests.
SMALL_SEGMENTER = {"stem": 8, "stages": (
    (8, 8, 3, 2, True, False, 1), (16, 8, 3, 2, False, False, 2),
    (16, 12, 5, 2, True, True, 1), (24, 12, 5, 2, True, True, 1))}


def small_pipeline(variant: str = "back", segmenter=None, seed: int = SEED):
    """(frames, port PipelineModels on the CPU, JAX PipelineModels) of the
    small setup: the four seeded networks (the ``variant`` detector, mesh,
    iris, blendshapes), the port's carrying the JAX params, and the
    full-width MobileFaceNet of seed ``seed + 4`` in both.  With
    ``segmenter`` ("general", "landscape", "multiclass") the port's models
    also carry that segmenter at :data:`SMALL_SEGMENTER`'s widths, and its
    JAX ConvertedModel is returned fourth."""
    frames = np.random.default_rng(seed).integers(0, 256, (B, H, W, 3),
                                                  dtype=np.uint8)
    models, *irs = random_init.random_pipeline_models(
        torch.from_numpy(frames), seed=seed, variant=variant,
        detector_blocks=1, mesh_blocks=1, per_image=12, iris_blocks=1,
        mixer_blocks=1, segmenter=segmenter,
        segmenter_spec=SMALL_SEGMENTER if segmenter else None)
    jms = []
    for ir, tm in zip(irs, (models.detector, models.mesh, models.iris,
                            models.blendshapes, models.segmentation)):
        jm = j_exec.convert_model(jax_ir(ir))
        tm.load_state_dict(t_exec.params_from_jax(
            ir, {k: np.asarray(v) for k, v in jm.params.items()}))
        jms.append(jm)
    jmodels = j_programs.PipelineModels(
        jms[0], variant, mesh=jms[1], iris=jms[2], blendshapes=jms[3],
        embedding=j_embedding.build_mobilefacenet(seed + 4))
    if segmenter:
        return frames, models, jmodels, jms[4]
    return frames, models, jmodels
