"""Checkpoint IO: a model's parameters in a ``.npz`` file.

Port of the JAX package's ``convert/checkpoint.py``.  The file holds the
parameters under the JAX package's keys and in its layouts (``t{index}``
in TFLite layout for a converted graph; ``stem_w``, ``b0_0_e_a``, ... with
HWIO filters for MobileFaceNet), so that a checkpoint written by either
package loads into both.  The graph's structure still comes from its
source (the ``.tflite`` file, or the architecture's code): a checkpoint
pairs with its model, and :func:`swap_params` checks that it does.
"""

from __future__ import annotations

import copy

import numpy as np

__all__ = ["save_params_npz", "load_params_npz", "swap_params"]

_META_PREFIX = "__meta"


def save_params_npz(model, path: str) -> None:
    """Writes ``model.jax_params()`` (a converted graph or MobileFaceNet)
    to ``path``."""
    np.savez_compressed(path, **model.jax_params())


def load_params_npz(path: str) -> dict[str, np.ndarray]:
    """The params dict saved by :func:`save_params_npz` (either package's)
    as numpy arrays; meta keys are ignored."""
    # No allow_pickle: every key a checkpoint holds is a plain numeric
    # array, and unpickling object arrays from an untrusted file would run
    # code before any validation.
    with np.load(path) as z:
        return {k: z[k] for k in z.files if not k.startswith(_META_PREFIX)}


def swap_params(model, params: dict, name: str = None):
    """A copy of ``model`` carrying ``params`` (JAX keys and layouts), and
    optionally a new ``name`` (FaceEmbedding reads it to tell trained
    weights), after checking that every key, shape and dtype matches the
    model's: a ValueError names the first mismatch."""
    want = model.jax_params()
    missing = set(want) - set(params)
    extra = set(params) - set(want)
    if missing or extra:
        raise ValueError(
            f"param tree mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]}")
    for k, v in want.items():
        got = np.asarray(params[k])
        if got.shape != v.shape:
            raise ValueError(f"shape mismatch for {k}: checkpoint "
                             f"{got.shape} vs graph {v.shape}")
        if got.dtype != v.dtype:
            # A float64 or integer checkpoint would otherwise load and
            # silently change precision.
            raise ValueError(f"dtype mismatch for {k}: checkpoint "
                             f"{got.dtype} vs graph {v.dtype}")
    out = copy.deepcopy(model)
    out.load_jax_params(params)
    if name is not None:
        out.name = name
    return out
