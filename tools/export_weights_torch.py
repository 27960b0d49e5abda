#!/usr/bin/env python
"""Offline weight export of the PyTorch port: ``.tflite`` -> ``.npz``
checkpoints.

The port's counterpart of ``tools/export_weights.py``: each graph is
converted by the port's ``convert/executor.py::convert_file`` and its
weights are written in the JAX package's keys and layouts
(``ConvertedModel.jax_params``), so that each ``<name>.npz`` holds the
same parameter keys and arrays as the JAX tool's file and loads in both
packages' ``convert.checkpoint.load_params_npz``.

    python tools/export_weights_torch.py [--src DIR] [--dst DIR]

``--src`` defaults to the port's model directory (``FDT_TPU_MODEL_DIR``,
else the JAX package's ``assets/models``), ``--dst`` to
``face_detection_tflite_torch/assets/checkpoints``.  Besides the
parameters, a file holds ``__meta_input_shapes__`` and
``__meta_output_shapes__`` as int64 arrays, one row a tensor, padded with
-1 to the longest rank: no object arrays, since neither loader unpickles.
Each written file is loaded back through ``load_params_npz`` and
``swap_params`` against its graph before the next one is converted.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def shapes_array(shapes) -> np.ndarray:
    """``[n, max rank]`` int64 of the tensor shapes, -1 past each rank."""
    shapes = [tuple(int(d) for d in s) for s in shapes]
    rank = max((len(s) for s in shapes), default=0)
    out = np.full((len(shapes), rank), -1, np.int64)
    for i, s in enumerate(shapes):
        out[i, :len(s)] = s
    return out


def export_file(path: str, dst_dir: str) -> str:
    """Converts one ``.tflite`` file and writes ``<name>.npz`` into
    ``dst_dir``; returns the written path."""
    from face_detection_tflite_torch.convert.checkpoint import (
        load_params_npz, swap_params)
    from face_detection_tflite_torch.convert.executor import convert_file

    name = os.path.splitext(os.path.basename(path))[0]
    cm = convert_file(path)
    out = dict(cm.jax_params())
    out["__meta_input_shapes__"] = shapes_array(cm.input_shapes)
    out["__meta_output_shapes__"] = shapes_array(cm.output_shapes)
    dst = os.path.join(dst_dir, f"{name}.npz")
    np.savez_compressed(dst, **out)
    swap_params(cm, load_params_npz(dst))  # raises on any mismatch
    print(f"{name}: {cm.num_params} params -> {dst} "
          f"({os.path.getsize(dst) / 1e6:.2f} MB)")
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None)
    ap.add_argument("--dst", default=os.path.join(
        REPO, "face_detection_tflite_torch", "assets", "checkpoints"))
    args = ap.parse_args(argv)

    from face_detection_tflite_torch.pipeline.detector import \
        resolve_model_dir
    src = args.src
    if src is None:
        try:
            src = resolve_model_dir()
        except FileNotFoundError as e:
            print(f"export_weights_torch: {e}", file=sys.stderr)
            return 1
    if not os.path.isdir(src):
        print(f"export_weights_torch: no directory {src}", file=sys.stderr)
        return 1
    paths = sorted(glob.glob(os.path.join(src, "*.tflite")))
    if not paths:
        print(f"export_weights_torch: no .tflite file in {src}",
              file=sys.stderr)
        return 1
    os.makedirs(args.dst, exist_ok=True)
    for path in paths:
        export_file(path, args.dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
