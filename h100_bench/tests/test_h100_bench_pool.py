"""A mix's pool follows its ``faces_cycle``: frames with each position's
count where the candidates have them, the nearest count where they have
run out; and a mix's ``calibrate_faces`` brings the detections a frame
near its target."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_tiny import tiny_cell
from h100_bench.harness import drive, netspec
from h100_bench.harness.frames import make_frames


class _Counts:
    """A stand-in reference whose frames hold the given detections."""

    def __init__(self, counts):
        self.counts = counts

    def count_faces(self, frames):
        return list(self.counts)


def _pool(counts, cycle, size):
    frames = np.arange(len(counts), dtype=np.uint8)[:, None, None, None]
    pool = drive.select_frames(_Counts(counts), frames,
                               {"faces_cycle": cycle, "pool": size},
                               torch.device("cpu"))
    return [counts[i] for i in pool[:, 0, 0, 0]], list(pool[:, 0, 0, 0])


def test_the_pool_follows_the_cycle_in_frame_order():
    counts = [13, 12, 14, 13, 9, 13, 12, 14, 13, 16]
    got, idx = _pool(counts, [12, 13, 14, 13], 8)
    assert got == [12, 13, 14, 13] * 2
    assert idx == [1, 0, 2, 3, 6, 5, 7, 8]


@pytest.mark.parametrize("counts, want", [
    # No 14 left: 13 and 15 are as near; the lower stands in.
    ([12, 13, 14, 13, 12, 13, 15, 13], [12, 13, 14, 13, 12, 13, 13, 15]),
    # No 12 at all: 11, then 13; the last 13 wanted takes the 16 left.
    ([11, 13, 14, 13, 16, 13, 14, 13], [11, 13, 14, 13, 13, 13, 14, 16])])
def test_a_count_that_runs_out_takes_the_nearest(counts, want):
    got, _ = _pool(counts, [12, 13, 14, 13], 8)
    assert got == want


def test_too_few_frames_for_the_pool_is_an_error():
    with pytest.raises(RuntimeError):
        _pool([13, 13], [13], 3)


def test_calibrate_faces_brings_detections_near_the_target():
    torch.set_num_threads(2)
    cell = tiny_cell("full.stream16")
    config, mix = cell["config"], cell["mix"]
    assert "calibrate_faces" in mix
    device = torch.device("cpu")
    nets = netspec.build_networks(config, 2 ** 31 + 7, device)
    frames = make_frames(mix["frames"], 2 ** 31 + 7, device)
    mix = dict(mix, calibrate_faces=3)
    ref = drive.calibrate(nets, frames, config, mix, device)
    with torch.inference_mode():
        mean = float(np.mean(ref.count_faces(torch.from_numpy(frames))))
    assert 2.0 <= mean <= 4.0, mean
