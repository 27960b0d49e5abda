#!/usr/bin/env python
"""The lint gate over the PyTorch port: ``tools/lint.py``'s two checks on
``face_detection_tflite_torch/`` and ``chip_smoke.py``, which that tool's
``PACKAGE`` and ``SCAN_DIRS`` leave out.

1. **Unused imports** (``lint.check_unused_imports``), over every ``.py``
   file of the port package and ``chip_smoke.py``.
2. **Runtime-unresolvable annotations** (``lint.check_annotations`` with
   ``PACKAGE`` set to the port): every port module is imported and the
   type hints of its functions, methods and classes resolved; the same
   for ``chip_smoke.py``'s functions.

A third finding is the port's own ground rule: after importing all of it,
no module of ``jax`` or of ``face_detection_tflite_tpu`` may be loaded.
This tool imports no ``jax`` itself (``tools/lint.py`` imports only the
standard library).

Usage: ``python tools/lint_torch.py`` -- exits non-zero with findings on
stderr; ``tests/test_torch_lint.py`` runs it.
"""

from __future__ import annotations

import ast
import importlib
import os
import sys
import typing
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import lint  # noqa: E402

PACKAGE = "face_detection_tflite_torch"
SCRIPTS = ("chip_smoke.py",)
#: What the port must never import.
FORBIDDEN = ("jax", "face_detection_tflite_tpu")


def py_files() -> list[str]:
    """The port package's ``.py`` files, then the scripts."""
    out = []
    for root, _dirs, files in os.walk(os.path.join(REPO, PACKAGE)):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out) + [os.path.join(REPO, f) for f in SCRIPTS]


def unused_imports(paths) -> list[str]:
    findings = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            findings.append(f"{os.path.relpath(path, REPO)}: syntax error: "
                            f"{e}")
            continue
        findings += lint.check_unused_imports(path, src, tree)
    return findings


def script_annotations() -> list[str]:
    """The type hints of each script's own functions, resolved."""
    findings = []
    for script in SCRIPTS:
        name = script[:-3]
        mod = importlib.import_module(name)
        for fname, obj in vars(mod).items():
            if callable(obj) and getattr(obj, "__module__", None) == name:
                try:
                    typing.get_type_hints(obj)
                except NameError as e:
                    findings.append(f"{script}: {fname}: unresolvable "
                                    f"annotation: {e}")
    return findings


def main() -> int:
    sys.path.insert(0, REPO)
    findings = unused_imports(py_files())
    with mock.patch.object(lint, "PACKAGE", PACKAGE):
        findings += lint.check_annotations()
    findings += script_annotations()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in FORBIDDEN)
    if leaked:
        findings.append(f"importing the port loaded {leaked[:5]} "
                        f"({len(leaked)} modules of {FORBIDDEN})")
    for f in findings:
        print(f, file=sys.stderr)
    if findings:
        print(f"lint_torch: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print(f"lint_torch: clean ({len(py_files())} files)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
