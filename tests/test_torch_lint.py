"""The lint gate over the PyTorch port (``tools/lint_torch.py``): the
unused-import and runtime-annotation checks of ``tools/lint.py`` on
``face_detection_tflite_torch/`` and ``chip_smoke.py``, and the rule that
the port imports nothing of ``jax`` or the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "lint_torch.py")
sys.path.insert(0, os.path.join(REPO, "tools"))

import lint_torch  # noqa: E402


def _run(*code: str):
    return subprocess.run([sys.executable, *code], capture_output=True,
                          text=True, cwd=REPO, timeout=300)


def test_port_lint_clean():
    proc = _run(TOOL)
    assert proc.returncode == 0, (
        f"lint findings:\n{proc.stderr}\n{proc.stdout}")
    assert "lint_torch: clean" in proc.stdout


def test_scans_the_port_and_the_smoke():
    rel = {os.path.relpath(p, REPO) for p in lint_torch.py_files()}
    assert "chip_smoke.py" in rel
    assert "face_detection_tflite_torch/pipeline/graphs.py" in rel
    assert not any(p.startswith("face_detection_tflite_tpu") for p in rel)


def test_flags_an_unused_import(tmp_path):
    path = tmp_path / "mod.py"
    path.write_text("import os\nimport sys\n\nprint(sys.argv)\n")
    (finding,) = lint_torch.unused_imports([str(path)])
    assert finding.endswith("unused import 'os' (as 'os')")


def test_flags_a_jax_module_loaded_with_the_port():
    """The gate fails where a JAX module is loaded next to the port."""
    proc = _run("-c", "import sys; sys.path.insert(0, 'tools'); "
                      "import face_detection_tflite_tpu.pipeline.config; "
                      "import lint_torch; sys.exit(lint_torch.main())")
    assert proc.returncode == 1
    assert "face_detection_tflite_tpu" in proc.stderr
