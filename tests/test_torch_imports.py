"""The PyTorch port stands alone: no module of it, nor ``chip_smoke.py``
nor the port's tools (``tools/*_torch.py``), imports ``jax`` or the JAX
package; and its entry points refuse to run on the CPU unless asked to."""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "face_detection_tflite_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
TOOLS = sorted(glob.glob(os.path.join(REPO, "tools", "*_torch.py")))


def _port_modules() -> list[str]:
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _port_files() -> list[str]:
    files = [SMOKE, *TOOLS]
    for root, _dirs, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def test_every_module_imports_without_jax():
    """Each module imports with ``jax`` and the JAX package blocked."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['face_detection_tflite_tpu'] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import runpy\n"
        f"for path in {[SMOKE, *TOOLS]!r}:\n"
        "    runpy.run_path(path, run_name='imported')\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_source(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    banned = ("jax", "face_detection_tflite_tpu")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, \
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"


def test_detector_without_device_raises_on_a_cpu_host():
    import torch

    from face_detection_tflite_torch import FaceDetector, PipelineModels
    from face_detection_tflite_torch.pipeline.detector import resolve_device
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FaceDetector(models=object())
    # The program path's models default to the card as well.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PipelineModels(object(), "back")
    assert resolve_device("cpu").type == "cpu"


def test_serving_without_device_raises_on_a_cpu_host():
    """``ServingPipeline`` and ``FaceServer`` over a detector built without
    ``device=`` raise on a CPU-only host, where the detector does."""
    import torch

    from face_detection_tflite_torch import (FaceDetector, FaceServer,
                                             ServingPipeline)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    for serve in (ServingPipeline, FaceServer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve(FaceDetector(models=object()))
