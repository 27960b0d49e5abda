"""The depthwise convolutions of the benchmark's five networks, as K7
runs them, and seeded arguments for each: shared by the CPU tests
(``test_torch_depthwise.py``) and the card tests
(``test_torch_kernels.py``, which import no JAX)."""

from __future__ import annotations

import torch

from face_detection_tflite_torch.convert import executor
from face_detection_tflite_torch.models import embedding, random_init

#: The benchmark's graphs (full width, full depth, seeded) by role.
GRAPHS = {
    "detector": lambda: random_init.blazeface_back_ir(5),
    "mesh": lambda: random_init.face_mesh_ir(5),
    "iris": lambda: random_init.iris_landmark_ir(5),
    "multiclass_segmenter": lambda: random_init.selfie_multiclass_ir(5),
}


def depthwise_sites(ir) -> list[tuple]:
    """``(h, w, c, k, stride, pads, act)`` of each distinct depthwise
    convolution of ``ir`` as K7 runs it (the act its plan gives K7)."""
    m = executor.convert_model(ir)
    sites = []
    for i, dw in m._depthwise.items():
        op = m._ops[i]
        _, h, w, c = m._shapes[op.inputs[0]]
        k = m._shapes[op.inputs[1]][1]
        pads = executor._conv_padding(op.options, h, w, k, k)
        site = (h, w, c, k, op.options["stride_h"],
                tuple(map(tuple, pads)), dw.act)
        if site not in sites:
            sites.append(site)
    return sites


def _mobilefacenet_sites() -> set:
    sites = set()
    for _, hw, c, k, s, prelu, same in embedding._depthwise_sites():
        pads = ((executor._same_pads(hw, s, k),) * 2 if same
                else ((0, 0), (0, 0)))
        sites.add(("embedding", hw, hw, c, k, s, pads,
                   "PRELU" if prelu else None))
    return sites


#: ``(role, h, w, c, k, stride, pads, act)`` of every distinct site.
SITES = sorted({(role, *site) for role, build in GRAPHS.items()
                for site in depthwise_sites(build())}
               | _mobilefacenet_sites(), key=repr)
SITE_IDS = [f"{s[0]}-{s[1]}x{s[2]}x{s[3]}-k{s[4]}s{s[5]}-{s[7]}"
            for s in SITES]


def site_args(site, seed: int, n: int = 2, device="cpu"):
    """Seeded input (with -0.0, NaN and +-inf planted), ``[C, 1, k, k]``
    filter, bias and PReLU slope of ``site`` at batch ``n``, and its
    stride, pads and act."""
    _, h, w, c, k, s, pads, act = site
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g)
    flat = x.view(-1)
    picks = torch.randperm(flat.numel(), generator=g)[:min(flat.numel(), 40)]
    for j, v in enumerate((-0.0, float("nan"), float("inf"),
                           float("-inf"))):
        flat[picks[j::4]] = v
    wt = torch.randn((c, 1, k, k), generator=g) / k
    bias = 0.1 * torch.randn(c, generator=g)
    alpha = torch.rand(c, generator=g) - 0.5 if act == "PRELU" else None
    x, wt, bias = (t.to(device) for t in (x, wt, bias))
    return x, wt, bias, s, pads, act, None if alpha is None \
        else alpha.to(device)
