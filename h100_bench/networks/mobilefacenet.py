"""MobileFaceNet (Chen et al. 2018, Table 1, batch norm folded away) with
the 192-dim output layer of the upstream package's
``mobilefacenet.tflite``: a parameter dict in the JAX package's layout
(HWIO filters keyed ``stem_w``, ``b0_0_e_a``, ...), which the port loads
through its checkpoint loader.

``blocks`` lists the bottlenecks (expansion, channels, repeats, stride);
He-normal filters, zero biases, PReLU slopes of 0.25.
"""

from __future__ import annotations

import math

import numpy as np


def layers(spec: dict) -> list[tuple]:
    """``(name, kh, kw, c_in, c_out, groups, prelu, stride)`` of every
    convolution, in the order the weights are drawn."""
    out = [("stem", 3, 3, 3, 64, 1, True, 2),
           ("stem_dw", 3, 3, 64, 64, 64, True, 1)]
    c_in = 64
    for bi, (t, c, n, s) in enumerate(spec["blocks"]):
        for ri in range(n):
            name = f"b{bi}_{ri}"
            out += [(f"{name}_e", 1, 1, c_in, c_in * t, 1, True, 1),
                    (f"{name}_d", 3, 3, c_in * t, c_in * t, c_in * t, True,
                     s if ri == 0 else 1),
                    (f"{name}_p", 1, 1, c_in * t, c, 1, False, 1)]
            c_in = c
    return out + [("head", 1, 1, c_in, 512, 1, True, 1),
                  ("gdconv", 7, 7, 512, 512, 512, False, 1),
                  ("out", 1, 1, 512, spec["embedding_dim"], 1, False, 1)]


def build(draws, spec: dict) -> dict:
    params = {}
    for name, kh, kw, c_in, c_out, groups, prelu, _ in layers(spec):
        fan_in = kh * kw * (c_in // groups)
        params[f"{name}_w"] = draws.normal(math.sqrt(2.0 / fan_in),
                                           (kh, kw, c_in // groups, c_out))
        params[f"{name}_b"] = np.zeros((c_out,), np.float32)
        if prelu:
            params[f"{name}_a"] = np.full((c_out,), 0.25, np.float32)
    return params
