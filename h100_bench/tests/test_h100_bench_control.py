"""The control of the correctness check: the reference with TF32
operands in the program's place must come out not correct, at a size a
test run holds on the CPU, and on the card at each cell's own size on
three seeds."""

from __future__ import annotations

import pytest
import torch

from bench_tiny import tiny_cell
from h100_bench import control
from h100_bench.harness import check, manifest
from h100_bench.reference.interp import round_tf32

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


def _judged(cell, seed, device, operands):
    r = control.readings(cell, seed, device, operands)
    ok, shown = check.judge(r["results"],
                            check.load_limits(cell["workload"]["name"]),
                            cell["config"])
    return ok, shown, r


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -3.0e-5])
    y = round_tf32(x)
    assert y[0] == 1.0 + 2.0 ** -10
    assert y[1] == 1.0                      # a tie rounds to even
    assert y[2] == 1.0 + 2.0 ** -10
    assert ((y.view(torch.int32) & 0x1FFF) == 0).all()


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_a_test_size(workload):
    torch.set_num_threads(2)
    ok, shown, r = _judged(tiny_cell(workload), 2 ** 31 + 3,
                           torch.device("cpu"), round_tf32)
    assert not ok, shown
    # The fp32 reference against itself reads nothing beyond the
    # readback's own rounding.
    same = control.readings(tiny_cell(workload), 2 ** 31 + 3,
                            torch.device("cpu"), None)["results"]["faces"][
                                "numbers"]
    assert same.pop("landmark_err_px") < 1e-9
    assert all(v == 0 for v in same.values()), same


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size_on_the_card(card, workload):
    cell = manifest.cell(manifest.load_manifest(), workload)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        ok, shown, _ = _judged(cell, seed, card, round_tf32)
        assert not ok, (seed, shown)
