"""The cell ``full_multiclass.segpipe16``: FULL with the multiclass selfie
segmenter through ``ServingPipeline(with_segmentation=True)``
(``loops/segment_pipeline.py``).  At a test size on the CPU its run is
correct, a mask broken after the readback is not, and the loop leaves no
pipeline worker behind; on the card the TF32 control fails the cell's
mask numbers at the cell's size on three seeds."""

from __future__ import annotations

import threading

import pytest
import torch

from bench_tiny import run_tiny
from face_detection_tflite_torch.models import segmentation as seg_mod
from h100_bench import control
from h100_bench.harness import check, manifest
from h100_bench.reference.interp import round_tf32

CELL = "full_multiclass.segpipe16"


def _workers() -> int:
    return sum(t.name == "fdt-serving" for t in threading.enumerate())


def test_the_cell_runs_correct_through_the_pipeline():
    before = _workers()
    result, err = run_tiny(CELL)
    assert result["correct"], err
    assert result["sample"]["masks"]["compared"] > 0
    assert result["sample"]["faces"]["faces"] > 0
    assert "mask_class_share" in result["checks"]
    assert "host ms a call by stage" in err[1] and "segment.wait" in err[1]
    assert _workers() == before


def test_a_mask_with_its_classes_swapped_is_not_correct(monkeypatch):
    real = seg_mod.SelfieSegmentation.materialize

    def swapped(self, handle):
        masks = real(self, handle)
        for m in masks:
            m.class_data = m.class_data[..., [0, 2, 1, 3, 4, 5]]
        return masks
    monkeypatch.setattr(seg_mod.SelfieSegmentation, "materialize", swapped)
    result, err = run_tiny(CELL)
    assert not result["correct"], err
    shown = result["checks"]["mask_class_share"]
    assert shown["value"] > shown["limit"], err


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_control_fails_the_cells_masks_at_its_size_on_the_card(card):
    cell = manifest.cell(manifest.load_manifest(), CELL)
    limits = check.load_limits(CELL)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        r = control.readings(cell, seed, card, round_tf32)
        ok, shown = check.judge(r["results"], limits, cell["config"])
        assert not ok, (seed, shown)
        assert shown["mask_err"]["value"] > shown["mask_err"]["limit"], (
            seed, shown)
