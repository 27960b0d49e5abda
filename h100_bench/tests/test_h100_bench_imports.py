"""What the benchmark loads: never ``jax`` or the JAX package (compared by
whole top-level module names: the port's name begins with the JAX
package's), and no result where it cannot run."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from bench_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "face_detection_tflite_tpu"}

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from h100_bench.harness import manifest, runner, system
import h100_bench.control
for m in manifest.load_manifest()["per_layer"]:
    manifest.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_nothing_run_py_imports_is_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "face_detection_tflite_torch" in top
    assert not top & FORBIDDEN


def test_the_harness_names_the_forbidden_modules_whole():
    from h100_bench.harness import runner
    assert set(runner.FORBIDDEN) == FORBIDDEN
    sys.modules.setdefault("face_detection_tflite_torch", sys)
    assert "face_detection_tflite_torch" not in runner.forbidden_modules()


def test_no_result_without_a_card():
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", "full.stream16",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "h100_bench"),
                    tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", "full.stream16",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
