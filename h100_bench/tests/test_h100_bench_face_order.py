"""The face check pairs a frame's faces in the reference's order: faces
whose scores lie within rounding of each other may come back in either
order, and are paired by their boxes; any other order is the program's
answer and is compared as it comes."""

from __future__ import annotations

import numpy as np
import pytest

from h100_bench.checks import faces
from h100_bench.reference.pipeline import EPS_SCORE

CONFIG = {"networks": {}}
HW = (853, 1280)


def _ref_face(k: int, score: float) -> dict:
    """A reference face at its own place in the frame."""
    x = 0.1 + 0.2 * k
    rng = np.random.default_rng(k)
    return {"box": np.asarray([x, 0.2, x + 0.1, 0.35], np.float32),
            "score": np.float32(score),
            "kp": rng.random((6, 2)).astype(np.float32),
            "mesh": (rng.random((468, 3)) * 500).astype(np.float32),
            "iris": (rng.random((10, 3)) * 500).astype(np.float32),
            "mesh_score": np.float32(0.9),
            "bs": rng.random(52).astype(np.float32),
            "angles": rng.random(3).astype(np.float32) * 10,
            "emb": None, "skip": set(), "gaps": {},
            "rois": {"192": np.ones((1, 4), np.float32)}}


def _frame(scores):
    return {"why": "", "faces": [_ref_face(k, s)
                                 for k, s in enumerate(scores)]}


def _answers(ref: dict, order) -> list[dict]:
    """The reference's faces in the program's form, in ``order``."""
    return [faces.as_program({"faces": [ref["faces"][k]]}, HW, CONFIG)[0]
            for k in order]


@pytest.mark.parametrize("scores, order", [
    ([0.99999994, 0.99999988], [1, 0]),
    ([1.0, 1.0, 0.9999999], [2, 0, 1]),
    ([0.9, 0.9 - EPS_SCORE / 2, 0.8], [1, 0, 2])])
def test_faces_tied_within_rounding_are_paired_by_box(scores, order):
    ref = _frame(scores)
    res = faces.compare([(_answers(ref, order), ref)], HW, CONFIG)
    assert res["counts"]["reordered"] == sum(
        k != p for p, k in enumerate(order))
    numbers = res["numbers"]
    assert numbers.pop("landmark_err_px") <= 0
    assert all(v == 0 for v in numbers.values()), numbers


@pytest.mark.parametrize("scores, order", [
    ([0.9, 0.8], [1, 0]),
    ([0.99999994, 0.99999988, 0.5], [0, 2, 1])])
def test_any_other_order_is_compared_as_it_comes(scores, order):
    ref = _frame(scores)
    res = faces.compare([(_answers(ref, order), ref)], HW, CONFIG)
    assert res["counts"]["reordered"] == 0
    assert res["numbers"]["box_err"] > 0.1
    assert res["numbers"]["kp_err_px"] > 1.0
