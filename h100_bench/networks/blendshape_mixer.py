"""The blendshape MLP-Mixer: no published widths, so its widths are set to
the parameter count of the published ``face_blendshapes.tflite`` (listed
under ``assumed`` in the configuration files).

``[1, tokens, 2]`` landmarks (image px), normalised, a projection to
``width``, ``blocks`` Mixer blocks (a token MLP of ``token_hidden``, a
channel MLP of ``channel_hidden``), a layer norm, a mean over the tokens
and a head: ``[1, outputs]`` coefficients in (0, 1); fp16 weights behind
DEQUANTIZE.
"""

from __future__ import annotations

import math

from h100_bench.harness.netspec import Builder, Graph


def build(draws, spec: dict) -> Graph:
    g = Builder(draws)
    tokens, width, outputs = spec["tokens"], spec["width"], spec["outputs"]
    inp = g.tensor((1, tokens, 2))
    centre = g.mean(inp, [1])
    x = g.op("SUB", [inp, centre], (1, tokens, 2))
    var = g.mean(g.op("SQUARED_DIFFERENCE", [inp, centre], (1, tokens, 2)),
                 [1, 2])
    x = g.op("MUL", [x, g.op("RSQRT", [var], (1, 1, 1))], (1, tokens, 2))
    x = g.fc(x, width, bias_std=0.1)
    for _ in range(spec["blocks"]):
        y = g.transpose(g.layer_norm(x), [0, 2, 1])
        y = g.transpose(g.mlp(y, spec["token_hidden"]), [0, 2, 1])
        x = g.op("ADD", [x, y], g.shape(x), activation=None)
        y = g.mlp(g.layer_norm(x), spec["channel_hidden"])
        x = g.op("ADD", [x, y], g.shape(x), activation=None)
    x = g.layer_norm(x)
    pooled = g.mean(x, [1], keep_dims=False)
    w = g.r.normal(1.5 / math.sqrt(width), (outputs, width))
    logits = g.op("FULLY_CONNECTED",
                  [pooled, g.half(w), g.half(g.r.normal(0.5, (outputs,)))],
                  (1, outputs), keep_num_dims=False)
    out = g.op("LOGISTIC", [logits], (1, outputs))
    return g.graph([inp], [out], "blendshape MLP-Mixer")
