"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import glob
import json
import os
import re

import pytest

from bench_tiny import ROOT
from h100_bench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.load_manifest(ROOT)


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert bench["command"] == ["python3", "h100_bench/run.py"]
    assert bench["paths"] == ["h100_bench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_lines(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("h100_bench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_bounds_and_sources(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        reported = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reported
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_finds_its_files_by_name(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(bench, w["name"], ROOT)
        assert cell["config"]["name"] == w["config"]
        assert manifest.plugin("loops", cell["mix"]["loop"]).run
        assert manifest.plugin("frames", cell["mix"]["frames"]["kind"]).make
        cfg = cell["config"]
        assert manifest.plugin("reference", cfg["reference"]).Reference
        for name in cfg.get("answers", ["faces"]):
            assert manifest.plugin("checks", name).compare
        for spec in cfg["networks"].values():
            if spec:
                assert manifest.plugin("networks", spec["builder"]).build
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(manifest.reader(m["name"]))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_no_cell_named_in_harness_code(bench):
    cells = [w["name"] for w in bench["workloads"]]
    code = [p for p in glob.glob(os.path.join(ROOT, "h100_bench", "**",
                                              "*.py"), recursive=True)
            if os.sep + "tests" + os.sep not in p]
    for path in code:
        with open(path) as f:
            text = f.read()
        for c in cells:
            assert c not in text, f"{path} names the cell {c}"


#: A segmenter's input and class planes, by ``SegmentationModel`` name.
SEGMENTERS = {"GENERAL": ([256, 256], 1), "LANDSCAPE": ([144, 256], 1),
              "MULTICLASS": ([256, 256], 6)}


def check_widths(cfg: dict) -> None:
    """A configuration states its networks' published inputs and shapes;
    a segmenting one its segmenter's, by the model it names."""
    from face_detection_tflite_torch import (FaceDetectionMode,
                                             FaceDetectionModel)
    from h100_bench.reference.mobilefacenet import BLOCKS
    assert cfg["precision"] == "highest"
    assert cfg["mode"] in FaceDetectionMode.__members__
    assert cfg["detector_model"] in FaceDetectionModel.__members__
    nets = cfg["networks"]
    assert nets["detector"]["input"] == 256
    assert nets["detector"]["anchors"] == 896
    assert nets["mesh"]["input"] == 192 and nets["iris"]["input"] == 64
    if nets.get("embedding"):
        # The reference states MobileFaceNet's bottlenecks itself.
        assert [tuple(b) for b in nets["embedding"]["blocks"]] == BLOCKS
    if nets.get("segmentation"):
        seg = cfg["segmentation"]
        assert seg["precision"] == "highest"
        assert seg["mask_dtype"] in ("float32", "uint8")
        spec = nets["segmentation"]
        assert [spec["in_hw"], spec["classes"]] == list(
            SEGMENTERS[seg["model"]])
        assert all(len(s) == 7 for s in spec["stages"])
        assert "masks" in cfg["answers"]


def test_configuration_files_state_their_widths(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        check_widths(cfg)


def test_a_module_name_from_data_stays_inside_its_folder():
    for bad in ("../run", "a.b", "", "/x"):
        with pytest.raises(ValueError):
            manifest.plugin("loops", bad)
