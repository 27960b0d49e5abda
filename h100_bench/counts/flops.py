"""Model FLOPs from the layer shapes: 2 per multiply-add of every
convolution, depthwise convolution, transposed convolution and
fully-connected layer.

``macs/<network>.json`` is the frozen count of one run of a network
(counted over the benchmark's graphs by :func:`graph_macs` and
:func:`mobilefacenet_macs`; a test holds the two equal), keyed by the
``name`` a configuration gives the network.  ``modes/<mode>.json`` says
how often a call in that mode runs each role: once a frame, or so many
times a returned face.  A window's work is what its inputs need, not the
slab's empty slots.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAKS = os.path.join(HERE, "peaks.json")


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def network_macs(name: str) -> int:
    """Multiply-adds of one run of the network ``name``."""
    return load(os.path.join(HERE, "macs", name + ".json"))["macs"]


def runs(mode: str) -> dict:
    """``{"per_frame": {role: runs}, "per_face": {role: runs}}`` of a
    call in ``mode``."""
    return load(os.path.join(HERE, "modes", mode + ".json"))


def graph_macs(graph) -> int:
    """Multiply-adds of one run of a graph (batch 1)."""
    total = 0
    for op in graph.ops:
        out = graph.tensors[op.outputs[0]].shape
        if op.name == "CONV_2D":
            _, kh, kw, cin = graph.tensors[op.inputs[1]].shape
            total += int(np.prod(out)) * kh * kw * cin
        elif op.name == "DEPTHWISE_CONV_2D":
            _, kh, kw, _ = graph.tensors[op.inputs[1]].shape
            total += int(np.prod(out)) * kh * kw
        elif op.name == "FULLY_CONNECTED":
            cout, cin = graph.tensors[op.inputs[1]].shape
            total += int(np.prod(out)) // cout * cin * cout
        elif op.name in ("TRANSPOSE_CONV",
                         "CUSTOM:Convolution2DTransposeBias"):
            # Each input value meets a filter tap of each output channel.
            w, x = ((op.inputs[0], op.inputs[1]) if op.name ==
                    "TRANSPOSE_CONV" else (op.inputs[1], op.inputs[0]))
            cout, kh, kw, cin = graph.tensors[w].shape
            total += int(np.prod(graph.tensors[x].shape)) * kh * kw * cout
    return total


def mobilefacenet_macs(layers, size: int = 112) -> int:
    """Multiply-adds of MobileFaceNet on one ``size`` px crop, from its
    layer list (``name, kh, kw, c_in, c_out, groups, prelu, stride``; TF
    SAME padding, the 7x7 global depthwise VALID)."""
    total, hw = 0, size
    for name, kh, kw, c_in, c_out, groups, _, stride in layers:
        hw = hw - kh + 1 if name == "gdconv" else -(-hw // stride)
        total += hw * hw * c_out * kh * kw * (c_in // groups)
    return total


def per_frame_flops(config: dict, faces: float) -> float:
    """FLOPs a frame with ``faces`` returned faces needs."""
    nets, r = config["networks"], runs(config["mode"])

    def macs(part):
        return sum(n * network_macs(nets[role]["name"])
                   for role, n in r[part].items() if nets.get(role))

    return 2.0 * (macs("per_frame") + faces * macs("per_face"))
