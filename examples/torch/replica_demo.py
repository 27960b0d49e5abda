#!/usr/bin/env python
"""Replica serving demo of the PyTorch port: a ReplicaPool.

The port's counterpart of ``examples/replica_demo.py``: a stream of
independent batches runs through a ``ReplicaPool``, where each replica
holds its own copy of the weights and its own pinned pipeline; batches go
round-robin, pass over a replica whose queue is full, and the futures are
read in submit order.  The replicas take the visible cards in turn, so on
a one-card machine two replicas share ``cuda:0`` (one's host work
overlaps the other's kernels); ``FDT_FORCE_CPU=1`` runs them on the CPU.
The detector comes from the command line's seam
(``face_detection_tflite_torch.cli._make_detector``).

    python examples/torch/replica_demo.py photo.jpg [--replicas 2]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image", help="photo each batch is made from")
    ap.add_argument("--replicas", type=int, default=2,
                    help="replicas, over the visible cards in turn")
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--model-dir", default=None)
    args = ap.parse_args(argv)

    from face_detection_tflite_torch.utils.backend import ensure_backend
    ensure_backend()
    from face_detection_tflite_torch import (FaceDetectionMode, ReplicaPool,
                                             cli)
    from face_detection_tflite_torch.parallel.sharding import \
        visible_devices
    from face_detection_tflite_torch.utils.image import load_image

    img = load_image(args.image)
    det = cli._make_detector(args)
    visible = visible_devices(det.device.type)
    devices = [visible[i % len(visible)] for i in range(args.replicas)]
    print(f"replicating over {len(devices)} devices: "
          f"{[str(d) for d in devices]}")
    with ReplicaPool(det, devices=devices,
                     mode=FaceDetectionMode.STANDARD) as pool:
        # A different input a batch (a roll), so each result is its own.
        futures = [pool.submit(np.stack([np.roll(img, 2 * i, axis=1)]))
                   for i in range(args.batches)]
        for i, fut in enumerate(futures):  # submit order is result order
            faces = fut.result(timeout=600)[0]
            print(f"batch {i:2d}: {len(faces)} face(s), "
                  f"score={faces[0].score:.3f}" if faces else
                  f"batch {i:2d}: no faces")
        print("replica stats:", pool.stats)
    print(f"weights resident on: "
          f"{sorted(str(d) for d in det._replica_params_cache)}")
    det.dispose()
    return 0


if __name__ == "__main__":
    sys.exit(main())
