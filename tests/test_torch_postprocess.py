"""The port's detection postprocess (plain version, on the CPU) against the
JAX package's ``detections.detection_postprocess`` vmapped over the batch.

Inputs are seeded raw detector outputs (``random_init.random_raw_detections``)
over the port's own anchors: BlazeFace back (256 px, A = 896) and full
range (192 px, A = 2304), with the letterbox of an 853x1280 frame (non-zero
top and bottom padding) unless a case says otherwise.  The seeds keep every
valid score at least 2e-4 (so at least 1e-4) from MIN_SCORE and from each
other, far more than 4 ulp, so the two sigmoids (which differ by up to two
ulp) agree on validity and order.

Tolerances: valid exact; scores within 2 ulp (``torch.sigmoid`` against
XLA's logistic); keypoints and boxes within 1e-6.  The kernel is held
against the plain version on the card in ``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_tflite_torch import FaceDetectionMode
from face_detection_tflite_torch.models import random_init
from face_detection_tflite_torch.ops.detections import (
    decode_detections, detection_postprocess, detection_postprocess_plain,
    remove_letterbox, weighted_nms)
from face_detection_tflite_torch.ops.letterbox import (letterbox_image,
                                                       letterbox_params)
from face_detection_tflite_torch.pipeline.gates import \
    apply_detection_gates_mask
from face_detection_tflite_torch.pipeline.programs import (
    _identify_detector_outputs, build_pipeline_program)
from face_detection_tflite_tpu.ops import detections as j_det

from .test_torch_kernels import postprocess_inputs

#: Cases of ``test_torch_kernels.POSTPROCESS_CASES`` held against JAX (all
#: but A = 2304 with every anchor valid, whose [2304, 2304] fixpoint is
#: slow on the CPU).
CASES = ["main", "all_valid", "full_5pct", "candidates_64", "more_leaders",
         "k_below_d", "none_valid", "equal_scores"]


def _jax(raw_boxes, raw_scores, anchors, size, padding, max_detections,
         num_candidates):
    fn = jax.vmap(lambda b, s: j_det.detection_postprocess(
        b, s, jnp.asarray(anchors), size, padding,
        max_detections=max_detections, num_candidates=num_candidates))
    return [np.asarray(r) for r in fn(jnp.asarray(raw_boxes),
                                      jnp.asarray(raw_scores))]


def _assert_matches_jax(got, ref):
    gb, gk, gs, gv = (t.numpy() for t in got)
    rb, rk, rs, rv = ref
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_max_ulp(gs, rs, maxulp=2)
    np.testing.assert_allclose(gk, rk, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gb, rb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax(case):
    rb, rs, anchors, size, pad, kw = postprocess_inputs(case, batch=3,
                                                        seed=len(case))
    got = detection_postprocess_plain(
        *(torch.from_numpy(a) for a in (rb, rs, anchors)), size, pad, **kw)
    _assert_matches_jax(got, _jax(rb, rs, anchors, size, pad, **kw))
    assert got[3].shape == (3, kw["max_detections"])


def test_plain_matches_jax_without_padding():
    """A square frame: the letterbox adds no padding."""
    rb, rs, anchors, size, _, kw = postprocess_inputs("main", batch=2,
                                                      seed=5)
    pad = letterbox_params(256, 256, 256, 256).padding
    assert pad == (0.0, 0.0, 0.0, 0.0)
    got = detection_postprocess_plain(
        *(torch.from_numpy(a) for a in (rb, rs, anchors)), size, pad, **kw)
    _assert_matches_jax(got, _jax(rb, rs, anchors, size, pad, **kw))


def test_seeds_are_not_marginal():
    """What the tolerances rest on: every valid score is >= 1e-4 from
    MIN_SCORE, and distinct valid scores are >= 4 ulp apart."""
    for case in CASES:
        rb, rs, anchors, size, _, _ = postprocess_inputs(case, batch=3,
                                                         seed=len(case))
        _, _, scores, valid = decode_detections(
            *(torch.from_numpy(a) for a in (rb, rs, anchors)), size)
        s = scores.numpy()
        assert (np.abs(s - 0.5) >= 1e-4).all()
        for row, v in zip(s, valid.numpy()):
            u = np.unique(row[v])
            if len(u) > 1:
                assert (np.diff(u) >= 4 * np.spacing(u[:-1])).all()


def test_empty_slab_rows_carry_the_letterbox_removal():
    """Rows after the last leader are zero before the letterbox removal, as
    in the JAX package: with top padding their y is -pad_top / scale."""
    rb, rs, anchors, size, pad, kw = postprocess_inputs("none_valid",
                                                        batch=1)
    boxes, kp, scores, valid = detection_postprocess_plain(
        *(torch.from_numpy(a) for a in (rb, rs, anchors)), size, pad, **kw)
    pt, pb, pl, pr = pad
    assert pt > 0 and not valid.any() and not scores.any()
    y = np.float32(-np.float32(pt)) / np.float32(1.0 - (pt + pb))
    assert (boxes[..., 1].numpy() == y).all()
    assert (kp[..., 1].numpy() == y).all()


def test_standard_program_uses_the_same_slab():
    """On the CPU the STANDARD program's detect stage (through
    ``detection_postprocess``) gives exactly the slab of the three-call
    composition it replaced: decode, weighted NMS, letterbox removal."""
    h, w, d = 96, 144, 4
    frames = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (2, h, w, 3), dtype=np.uint8))
    models, *_ = random_init.random_pipeline_models(
        frames, seed=11, detector_blocks=1, mesh_blocks=1, per_image=12,
        iris_blocks=1, mixer_blocks=1)
    with torch.inference_mode():
        out = build_pipeline_program(models, h, w, FaceDetectionMode.STANDARD,
                                     max_faces=d, face_slab=2)(frames)
        lbp = letterbox_params(h, w, 256, 256)
        raw_boxes, raw_scores = _identify_detector_outputs(
            models.detector(letterbox_image(frames, lbp)))
        args = (raw_boxes, raw_scores, models.anchors, 256.0, lbp.padding)
        boxes, kp, scores, valid = decode_detections(*args[:4])
        boxes, kp, scores, valid = weighted_nms(boxes, kp, scores, valid,
                                                max_detections=d)
        boxes, kp = remove_letterbox(boxes, kp, lbp.padding)
        fused = detection_postprocess(*args, max_detections=d)
    for a, b in zip((boxes, kp, scores, valid), fused):
        assert torch.equal(a, b)
    valid = apply_detection_gates_mask(valid, scores, boxes, min_score=0.0,
                                       min_face_size=0.0, image_width=float(w))
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    take = torch.arange(2)[:, None], order
    assert valid.any()
    assert torch.equal(out["det_boxes"], boxes[take])
    assert torch.equal(out["det_raw_keypoints"], kp[take])
    assert torch.equal(out["det_scores"], scores[take])
    assert torch.equal(out["det_valid"], valid[take])
