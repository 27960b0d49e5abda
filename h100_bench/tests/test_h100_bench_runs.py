"""The whole harness on the CPU at a tiny size: the plain reference
agrees with the port's CPU path, and each fault a cell can have, planted
under the timed path, makes ``correct`` false."""

from __future__ import annotations

import pytest

from bench_tiny import run_tiny
from face_detection_tflite_torch.pipeline import detector as det_mod
from face_detection_tflite_torch.pipeline import geometry

CELLS = ["full.stream16", "full_embed.stream16", "full.single720"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(workload):
    result, err = run_tiny(workload)
    assert result["correct"], err
    counts = result["sample"]["faces"]
    assert counts["compared"] > 0 and counts["faces"] > 0
    assert result["checks"]["face_mismatch"]["value"] == 0
    assert list(result)[-1] == "checks"
    assert err[-1].startswith("check ")


def _altered_mesh(monkeypatch):
    """An answer altered where it is produced: one mesh point 0.5 px off."""
    real = geometry.transform_mesh_to_absolute

    def altered(*args):
        out = real(*args).clone()
        out[..., 7, 0] += 0.5
        return out
    monkeypatch.setattr(geometry, "transform_mesh_to_absolute", altered)


def _half_batch(monkeypatch):
    """Half of each batch left out: its frames reach the program black."""
    real = det_mod.FaceDetector._prepare_batch

    def half(self, raw, device=None):
        images, b, wh = real(self, raw, device)
        images = images.clone()
        images[(b + 1) // 2:] = 0
        return images, b, wh
    monkeypatch.setattr(det_mod.FaceDetector, "_prepare_batch", half)


def _unchanged(monkeypatch):
    """A call that returns the state unchanged: the previous call's
    faces again."""
    real = det_mod.FaceDetector._stream_finish
    last = {}

    def stale(self, item, mode):
        out = real(self, item, mode)
        prev = last.get("out", out)
        last["out"] = out
        return prev if len(prev) == len(out) else out
    monkeypatch.setattr(det_mod.FaceDetector, "_stream_finish", stale)


@pytest.mark.parametrize("workload, fault", [
    ("full_embed.stream16", _altered_mesh),
    ("full_embed.stream16", _half_batch),
    ("full_embed.stream16", _unchanged),
    # One frame a call: no half of a batch to leave out.
    ("full.single720", _altered_mesh),
    ("full.single720", _unchanged)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, workload):
    fault(monkeypatch)
    result, err = run_tiny(workload)
    assert not result["correct"], err


def test_the_cpu_run_reports_what_a_card_run_reports():
    result, _ = run_tiny("full.single720")
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device", "checks"}
    assert set(result["metrics"]) == {"frame_p95_ms", "setup_s"}
