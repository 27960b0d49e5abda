"""The port's weighted NMS (plain version on the CPU) against the JAX
package's ``weighted_nms`` fixpoint and its Pallas kernel in interpret
mode.  The CUDA kernel is held against the plain version in
``tests/test_torch_kernels.py``.

Budgets: leader masks and slabs equal exactly, boxes within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_tflite_torch.ops import nms as t_nms
from face_detection_tflite_torch.ops.detections import (_topk_candidates,
                                                        weighted_nms)
from face_detection_tflite_tpu.ops import detections as j_det
from face_detection_tflite_tpu.ops.nms_pallas import nms_core_pallas


def _random_candidates(rng, n, overlap_prob=0.5):
    """Clustered candidates, as tests/test_nms_pallas.py builds them."""
    boxes, scores = [], []
    for _ in range(n):
        if boxes and rng.uniform() < overlap_prob:
            b = np.asarray(boxes[rng.integers(len(boxes))])
            b = b + rng.normal(0, 0.02, 4)
        else:
            x0, y0 = rng.uniform(0, 0.7, 2)
            w, h = rng.uniform(0.05, 0.3, 2)
            b = np.asarray([x0, y0, x0 + w, y0 + h])
        boxes.append(b.tolist())
        scores.append(float(rng.uniform(0.0, 1.0)))
    return np.asarray(boxes, np.float32), np.asarray(scores, np.float32)


def _batch(seed, n, b=2, valid_frac=0.5):
    rng = np.random.default_rng(seed)
    out = [[], [], [], []]
    for _ in range(b):
        boxes, scores = _random_candidates(rng, n)
        kp = rng.normal(size=(n, 6, 2)).astype(np.float32)
        valid = scores >= 1.0 - valid_frac
        for lst, v in zip(out, (boxes, kp, scores, valid)):
            lst.append(v)
    return [np.stack(v) for v in out]


def _port(args, d, k=None):
    res = weighted_nms(*(torch.from_numpy(a) for a in args),
                       max_detections=d, num_candidates=k)
    return [r.numpy() for r in res]


def _jax(args, d, k=None):
    fn = jax.vmap(lambda b, kp, s, v: j_det.weighted_nms(
        b, kp, s, v, max_detections=d, num_candidates=k))
    return [np.asarray(r) for r in fn(*(jnp.asarray(a) for a in args))]


def _assert_slab_equal(got, ref):
    gb, gk, gs, gv = got
    rb, rk, rs, rv = ref
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gs, rs)
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_allclose(gb, rb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [64, 896, 2304])
def test_plain_matches_jax_weighted_nms(n):
    args = _batch(n, n, valid_frac=0.5 if n == 64 else 0.05)
    _assert_slab_equal(_port(args, 16), _jax(args, 16))


@pytest.mark.parametrize("seed", range(4))
def test_plain_matches_jax_random_clusters(seed):
    args = _batch(100 + seed, 64)
    _assert_slab_equal(_port(args, 8, 64), _jax(args, 8, 64))


@pytest.mark.parametrize("k", [64, 256])
def test_plain_core_matches_pallas_interpret(k):
    """The core (leader mask, blended boxes) against the Pallas kernel."""
    boxes, kp, scores, valid = _batch(7 + k, k)
    tb, _, ts, tv = _topk_candidates(torch.from_numpy(boxes),
                                     torch.from_numpy(kp),
                                     torch.from_numpy(scores),
                                     torch.from_numpy(valid), k)
    leader, blended = t_nms.nms_core_plain(tb, ts, tv)
    for i in range(boxes.shape[0]):
        jl, jb = nms_core_pallas(jnp.asarray(tb[i].numpy()),
                                 jnp.asarray(ts[i].numpy()),
                                 jnp.asarray(tv[i].numpy()), 0.3,
                                 interpret=True)
        np.testing.assert_array_equal(leader[i].numpy(), np.asarray(jl))
        np.testing.assert_allclose(blended[i].numpy(), np.asarray(jb),
                                   rtol=0, atol=1e-6)


def test_empty_input():
    args = [np.zeros((2, 32, 4), np.float32), np.zeros((2, 32, 6, 2),
                                                       np.float32),
            np.zeros((2, 32), np.float32), np.zeros((2, 32), bool)]
    got = _port(args, 4)
    assert not got[3].any()
    _assert_slab_equal(got, _jax(args, 4))


def test_single_cluster_blend():
    boxes = np.asarray([[[0.0, 0.0, 0.5, 0.5],
                         [0.05, 0.05, 0.55, 0.55]]], np.float32)
    kp = np.full((1, 2, 6, 2), 0.3, np.float32)
    scores = np.asarray([[0.9, 0.8]], np.float32)
    valid = np.asarray([[True, True]])
    ob, _, osc, ov = _port([boxes, kp, scores, valid], 4, 2)
    assert ov.sum() == 1 and ov.shape == (1, 4)
    assert osc[0, 0] == pytest.approx(0.9)
    expected = (0.9 * boxes[0, 0] + 0.8 * boxes[0, 1]) / 1.7
    np.testing.assert_allclose(ob[0, 0], expected, atol=1e-6)


def test_equal_scores_keep_top_k_order():
    """Equal scores: the stable descending sort keeps index order, as
    lax.top_k does, so the same candidate leads its cluster."""
    boxes = np.asarray([[[0.1, 0.1, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9],
                         [0.12, 0.1, 0.42, 0.4], [0.62, 0.6, 0.92, 0.9]]],
                       np.float32)
    kp = np.arange(48, dtype=np.float32).reshape(1, 4, 6, 2)
    scores = np.full((1, 4), 0.8, np.float32)
    valid = np.ones((1, 4), bool)
    got, ref = _port([boxes, kp, scores, valid], 4), \
        _jax([boxes, kp, scores, valid], 4)
    _assert_slab_equal(got, ref)
    np.testing.assert_array_equal(got[1][0, :2], kp[0, :2])

