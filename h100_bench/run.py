#!/usr/bin/env python3
"""The benchmark of ``face_detection_tflite_torch`` on NVIDIA H100 cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  ``<cell>`` is a ``workloads`` entry of
``BENCHMARK.json``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: every number the
correctness check compared, beside its limit); the same numbers end
standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.  It exits
non-zero, with no result, where CUDA is unavailable or has fewer cards
than the cell asks for, or where ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux: from
    ``/proc``), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache at a fixed path inside the checkout.
_CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from h100_bench.harness import manifest, runner

    cell = manifest.cell(manifest.load_manifest(), args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, err = runner.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0), T0,
                             cell)
    found = runner.forbidden_modules()
    if found:
        print(f"loaded modules the port may not use: {found}",
              file=sys.stderr)
        return 3
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
