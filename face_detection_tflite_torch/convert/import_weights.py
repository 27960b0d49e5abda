"""Trained-weight import for MobileFaceNet.

Port of the JAX package's ``convert/import_weights.py``.  The reference
loads ``mobilefacenet.tflite`` as a package asset (`face_embedding.dart:46`);
the file is not in this repository.  Users who have weights bring them in
one of three forms:

1. **A .tflite file**: nothing to import; ``FaceEmbedding.load`` converts
   it.
2. **A PyTorch MobileFaceNet checkpoint** (a ``.pt``/``.pth`` state dict,
   the common public form, including the InsightFace_Pytorch layout with
   its 2-D Linear + BatchNorm1d tail): BatchNorm folds into the conv
   weights and biases, OIHW transposes to HWIO, the PReLU slopes map to
   the ``_a`` tensors, and the result is validated tensor by tensor
   against the template of :func:`~..models.embedding.build_mobilefacenet`.
3. **A .npz already in this naming**: shape-validated.

The result is the JAX package's params dict (the same keys, HWIO
filters), so a ``.npz`` of it loads into either package
(``FaceEmbedding.load``, ``convert/checkpoint.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fold_bn", "import_mobilefacenet",
           "import_mobilefacenet_state_dict", "import_mobilefacenet_npz",
           "BN_EPS"]

BN_EPS = 1e-5


def fold_bn(w_oihw, gamma, beta, mean, var, eps=BN_EPS):
    """Folds inference BatchNorm into a conv: returns (w, b) with
    w' = w * gamma/sqrt(var+eps) (per out-channel), b' = beta - mean*scale.
    """
    scale = gamma / np.sqrt(var + eps)
    w = w_oihw * scale[:, None, None, None]
    b = beta - mean * scale
    return w, b


def _oihw_to_hwio(w):
    return np.transpose(w, (2, 3, 1, 0))


def _template() -> dict[str, np.ndarray]:
    """The params of the seeded MobileFaceNet: the keys and shapes an
    import must produce."""
    from ..models.embedding import build_mobilefacenet
    return build_mobilefacenet().jax_params()


def _conv_order():
    """The template's conv layers in forward order with (has_prelu)."""
    from ..models.embedding import _MFN_BLOCKS
    order = [("stem", True), ("stem_dw", True)]
    for bi, (_t, _c, n, _s) in enumerate(_MFN_BLOCKS):
        for ri in range(n):
            order += [(f"b{bi}_{ri}_e", True), (f"b{bi}_{ri}_d", True),
                      (f"b{bi}_{ri}_p", False)]
    order += [("head", True), ("gdconv", False), ("out", False)]
    return order


def import_mobilefacenet_state_dict(state_dict) -> dict:
    """Maps an ordered PyTorch-style MobileFaceNet state dict onto the
    ``build_mobilefacenet`` params.

    Matching is by order (the module order of the MobileFaceNet paper,
    which public implementations follow): each conv layer takes a 4-D
    ``*.weight``, then its BatchNorm quartet (found by the prefix of its
    ``*.running_mean``), then, for PReLU layers, a 1-D slope tensor.
    Names are free; only order and shapes matter.
    """
    items = [(k, np.asarray(v)) for k, v in state_dict.items()
             if not k.endswith("num_batches_tracked")]

    bn_prefixes = [k[: -len(".running_mean")] for k, _ in items
                   if k.endswith(".running_mean")]

    def bn_group(prefix):
        d = dict(items)
        try:
            return (d[prefix + ".weight"], d[prefix + ".bias"],
                    d[prefix + ".running_mean"], d[prefix + ".running_var"])
        except KeyError as e:
            raise ValueError(f"BatchNorm group {prefix!r} is missing {e}")

    bn_keys = {f"{p}.{s}" for p in bn_prefixes
               for s in ("weight", "bias", "running_mean", "running_var")}
    # 4-D tensors are convs; a 2-D `.weight` is a final nn.Linear (the
    # InsightFace_Pytorch tail: Linear + BatchNorm1d), a 1x1 conv in
    # effect, so (out, in) reshapes to OIHW and its BN folds likewise.
    convs = [(k, v if v.ndim == 4 else v[:, :, None, None])
             for k, v in items
             if v.ndim in (2, 4) and k.endswith(".weight")
             and k not in bn_keys]
    # 1-D tensors that are neither BN components nor conv biases are PReLU
    # slopes (MobileFaceNet's convs carry no bias before the fold).
    prelus = [(k, v) for k, v in items
              if v.ndim == 1 and k not in bn_keys]
    order = _conv_order()
    if len(convs) != len(order):
        raise ValueError(
            f"checkpoint has {len(convs)} conv layers; MobileFaceNet "
            f"expects {len(order)} (is this the paper layout?)")
    if len(bn_prefixes) != len(order):
        raise ValueError(
            f"checkpoint has {len(bn_prefixes)} BatchNorm layers; "
            f"expected {len(order)} (one per conv)")
    n_prelu = sum(1 for _, p in order if p)
    if len(prelus) != n_prelu:
        raise ValueError(
            f"checkpoint has {len(prelus)} PReLU slope tensors; "
            f"expected {n_prelu}")

    template = _template()
    params: dict = {}
    pi = 0
    for (name, has_prelu), (ck, cw), bnp in zip(order, convs, bn_prefixes):
        g, b, m, v = bn_group(bnp)
        w, bias = fold_bn(cw.astype(np.float64), g.astype(np.float64),
                          b.astype(np.float64), m.astype(np.float64),
                          v.astype(np.float64))
        w = _oihw_to_hwio(w).astype(np.float32)
        want = tuple(template[f"{name}_w"].shape)
        if w.shape != want:
            raise ValueError(
                f"{name}: checkpoint conv {ck!r} folds to {w.shape}, "
                f"template expects {want}")
        params[f"{name}_w"] = w
        params[f"{name}_b"] = bias.astype(np.float32)
        if has_prelu:
            pk, alpha = prelus[pi]
            pi += 1
            c_out = want[-1]
            if alpha.shape not in ((c_out,), (1,)):
                raise ValueError(
                    f"{name}: PReLU slope {pk!r} has shape {alpha.shape}, "
                    f"expected ({c_out},) or (1,)")
            params[f"{name}_a"] = np.broadcast_to(
                alpha.astype(np.float32), (c_out,)).copy()
    missing = set(template) - set(params)
    if missing:
        raise ValueError(f"import incomplete: missing {sorted(missing)[:5]}")
    return params


def import_mobilefacenet_npz(path: str) -> dict:
    """Loads a .npz already in this naming and shape-validates it."""
    template = _template()
    with np.load(path) as z:
        params = {k: z[k] for k in z.files if not k.startswith("__meta")}
    missing = set(template) - set(params)
    extra = set(params) - set(template)
    if missing or extra:
        raise ValueError(f"param tree mismatch: missing="
                         f"{sorted(missing)[:5]} extra={sorted(extra)[:5]}")
    for k, v in params.items():
        if tuple(v.shape) != tuple(template[k].shape):
            raise ValueError(f"shape mismatch for {k}: {tuple(v.shape)} vs "
                             f"{tuple(template[k].shape)}")
    return params


def import_mobilefacenet(src: str) -> dict:
    """The params of the checkpoint at ``src``: a ``.npz`` in this naming,
    or a ``.pt``/``.pth``/``.bin`` PyTorch state dict (also wrapped in a
    module or under a ``"state_dict"`` key), loaded with
    ``weights_only=True``."""
    if src.endswith(".npz"):
        return import_mobilefacenet_npz(src)
    if src.endswith((".pt", ".pth", ".bin")):
        sd = torch.load(src, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        if "state_dict" in sd and isinstance(sd["state_dict"], dict):
            sd = sd["state_dict"]
        return import_mobilefacenet_state_dict(
            {k: v.numpy() for k, v in sd.items()})
    raise ValueError(f"unsupported checkpoint format: {src} "
                     "(expected .npz, .pt, .pth or use a .tflite directly)")
