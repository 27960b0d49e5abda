"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads[]``) names a configuration and a traffic mix; the
configuration's file is ``configs[].file``, the mix's is
``h100_bench/traffic/<mix>.json``; a per-layer metric's reader is
``h100_bench/metrics/<metric>.py``, or, for a metric split by the
end-to-end metric it moves (``<metric>.<part>``), the reader of the
name before the first dot where the split has no file of its own.
The code a data file names is a module found by that name
(:func:`plugin`): a mix's ``loop`` in ``h100_bench/loops/``, its
frames' ``kind`` in ``h100_bench/frames/``, a network's ``builder`` in
``h100_bench/networks/``, a configuration's ``reference`` in
``h100_bench/reference/``.  Nothing here names a cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(manifest: dict, workload: str, root: str = ROOT) -> dict:
    """The cell ``workload``: its entry, configuration, mix, and the
    metrics it reports (``end_to_end`` and ``per_layer`` entries)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    return {"workload": w, "config": config, "mix": mix,
            "end_to_end": [m for m in manifest["end_to_end"] if reports(m)],
            "per_layer": [m for m in manifest["per_layer"] if reports(m)]}


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py`` (or of the part of
    the name before its first dot)."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(BENCH, "metrics", metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def plugin(kind: str, name: str):
    """The module ``h100_bench/<kind>/<name>.py``, for the name a data
    file gives."""
    if not NAME.match(name) or "." in name:
        raise ValueError(f"not a module name: {name!r}")
    return importlib.import_module(f"h100_bench.{kind}.{name}")
