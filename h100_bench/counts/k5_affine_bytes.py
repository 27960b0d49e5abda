"""The bytes of K5's affine pass (``csrc/epilogue.cu``,
``residual_act_affine_kernel``): what the graph's per-channel affine
pairs need, each byte once, counted from the graph alone.

A pair is a 4-D MUL by one constant a channel whose output only an ADD
of one constant a channel reads (a batch norm the graph keeps, as
iResNet's before a zero-padded convolution).  Its input ``x`` comes out
of a pass, the op ``P`` that writes it (a residual ADD, a PReLU); the
pass computes ``x`` and the pair's output ``z`` from ``P``'s activation
inputs.  Per run of the network (batch 1), each site needs: each of
``P``'s activation inputs read once, ``z`` written once, and ``x``
written once where another op reads it or it is a graph output; 4
bytes a float32 value.  The per-channel constants (a bias, the PReLU's
slopes, the pair's scale and shift: a few KiB a launch, read once a
launch and not a face) are left out, so the count is a floor.

``k5_affine/<network>.json`` is the frozen count of one run of a
network (a test holds it equal to :func:`graph_bytes` over the
benchmark's graph), keyed by the ``name`` a configuration gives it.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def network_bytes(name: str) -> int | None:
    """Bytes of one run of the network ``name``'s affine sites, or None
    where the benchmark counts none for it."""
    path = os.path.join(HERE, "k5_affine", name + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["bytes"]


def sites(graph) -> list[dict]:
    """Each affine site of ``graph``: ``{"shape", "inputs", "keep"}``,
    the pair's 4-D shape, the activation inputs of the op that writes
    its input, and whether that input has another reader (or is a graph
    output)."""
    producer = {t: op for op in graph.ops for t in op.outputs}
    readers: dict[int, list] = {}
    for op in graph.ops:
        for t in op.inputs:
            readers.setdefault(t, []).append(op)

    def const(t) -> bool:
        return graph.tensors[t].data is not None

    def per_channel(t, c) -> bool:
        shp = graph.tensors[t].shape
        return const(t) and len(shp) >= 1 and shp[-1] == c and \
            all(d == 1 for d in shp[:-1])

    out = []
    for op in graph.ops:
        if op.name != "MUL" or len(op.inputs) != 2:
            continue
        a, b = op.inputs
        x, s = (b, a) if const(a) else (a, b)
        shape = graph.tensors[x].shape
        mid = op.outputs[0]
        if const(x) or len(shape) != 4 or not per_channel(s, shape[3]) or \
                len(readers.get(mid, [])) != 1 or x not in producer:
            continue
        add = readers[mid][0]
        other = [t for t in add.inputs if t != mid]
        if add.name != "ADD" or len(other) != 1 or \
                not per_channel(other[0], shape[3]):
            continue
        writer = producer[x]
        out.append({"shape": shape,
                    "inputs": [graph.tensors[t].shape for t in writer.inputs
                               if not const(t)],
                    "keep": len(readers[x]) > 1 or x in graph.outputs})
    return out


def graph_bytes(graph) -> int:
    """Bytes of one run of ``graph``'s affine sites (batch 1)."""
    total = 0
    for site in sites(graph):
        n = int(np.prod(site["shape"]))
        total += 4 * (sum(int(np.prod(s)) for s in site["inputs"])
                      + n * (2 if site["keep"] else 1))
    return total
