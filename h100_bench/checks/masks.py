"""``masks``: the program's segmentation masks against the plain
reference's (``reference/segmentation.py``), frame by frame, at the
model's resolution with the letterbox padding in: each frame's answer
carries its ``SegmentationMask`` under ``"mask"``.  The configuration's
``segmentation`` block states the ``model`` and the ``mask_dtype`` the
planes are read back in.

Numbers compared (each against the cell's limit in
``limits/<cell>.json``):

* ``mask_mismatch``: frames whose plane size, class count, original size
  or normalised padding differ (exact, limit 0): a mask of the wrong
  frame or of a wrong letterbox;
* ``mask_err``: the largest gap of a plane value (for MULTICLASS also of
  the person plane, one less the background's) beyond what the
  readback's rounding explains, half of 1/255 for ``uint8`` and 0 for
  ``float32``: the network and the softmax;
* ``mask_code_share`` (``uint8`` only): the share of plane values whose
  uint8 code differs from the code of the reference's value; a code
  differs only where rounding lands a value on the other side of a code
  boundary, or the value is wrong;
* ``mask_class_share`` (MULTICLASS only): the share of pixels whose most
  probable class differs, over the pixels whose two highest reference
  probabilities lie more than rounding apart (:data:`EPS_CLASS`, and
  1/255 more for ``uint8``, where the program compares codes); the
  others are counted as skipped.
"""

from __future__ import annotations

import numpy as np

from h100_bench.reference.segmentation import Reference

NUMBERS = ("mask_mismatch", "mask_err", "mask_code_share",
           "mask_class_share")

#: Probability gap within which fp32 rounding may flip the most probable
#: class between the program and the reference: 28 times the largest gap
#: of a plane value that sound runs of the multiclass segmenter read on
#: the card (3.6e-7), a ninth of the smallest that its TF32 control reads
#: (8.8e-5), which then flips classes on every seed.
EPS_CLASS = 1e-5


def _uint8(config: dict) -> bool:
    return config["segmentation"]["mask_dtype"] == "uint8"


def names(config: dict) -> list[str]:
    out = ["mask_mismatch", "mask_err"]
    if _uint8(config):
        out.append("mask_code_share")
    if config["segmentation"]["model"] == "MULTICLASS":
        out.append("mask_class_share")
    return out


def reference(config: dict, nets: dict, device):
    return Reference(nets, device, config)


def port_answer(answer: dict, config: dict) -> dict:
    """A frame's ``SegmentationMask`` as :func:`compare` takes it: the
    planes read back (the six class planes, or the one), the person
    plane, the mask's size, the frame's and the padding."""
    m = answer["mask"]
    classes = getattr(m, "class_data", None)
    return {"planes": np.asarray(m.data[..., None] if classes is None
                                 else classes),
            "person": np.asarray(m.data), "size": (m.width, m.height),
            "original": (m.original_width, m.original_height),
            "padding": tuple(m.padding)}


def as_program(frame: dict, frame_hw, config: dict) -> dict:
    """A reference frame's mask in the program's form: the planes through
    the readback's rounding (``uint8``: ``round(clip(p, 0, 1) * 255) /
    255`` in float32), the person plane one less the background for
    MULTICLASS."""
    p = frame["planes"].astype(np.float32)
    if _uint8(config):
        p = np.round(np.clip(p, 0.0, 1.0) * 255.0).astype(
            np.float32) * np.float32(1.0 / 255.0)
    person = 1.0 - p[..., 0] if p.shape[-1] > 1 else p[..., 0]
    return {"planes": p, "person": person, "size": frame["size"],
            "original": frame["original"], "padding": frame["padding"]}


def compare(pairs, frame_hw, config: dict) -> dict:
    """``pairs``: [(program mask as a dict, reference frame dict)].
    Returns the numbers, the counts and ``bad``, the pairs that fail the
    exact number."""
    uint8 = _uint8(config)
    allow = 0.5 / 255.0 if uint8 else 0.0
    margin = EPS_CLASS + (1.0 / 255.0 if uint8 else 0.0)
    out = {k: 0.0 for k in NUMBERS}
    codes = code_differ = pixels = class_differ = 0
    bad = []
    n = {"frames": len(pairs), "compared": 0, "class_pixels_skipped": 0,
         "bad_frames": 0}
    for p, (got, ref) in enumerate(pairs):
        n["compared"] += 1
        want = ref["planes"].astype(np.float64)
        g = got["planes"].astype(np.float64)
        if (g.shape != want.shape or got["size"] != ref["size"]
                or got["original"] != ref["original"]
                or tuple(got["padding"]) != tuple(ref["padding"])):
            out["mask_mismatch"] += 1
            n["bad_frames"] += 1
            bad.append(p)
            continue
        gap = float(np.max(np.abs(g - want)))
        if want.shape[-1] > 1:
            gap = max(gap, float(np.max(np.abs(
                got["person"].astype(np.float64) - (1.0 - want[..., 0])))))
            top = np.sort(want, axis=-1)
            clear = top[..., -1] - top[..., -2] > margin
            pixels += int(np.count_nonzero(clear))
            n["class_pixels_skipped"] += int(clear.size
                                             - np.count_nonzero(clear))
            class_differ += int(np.count_nonzero(
                clear & (np.argmax(g, -1) != np.argmax(want, -1))))
        out["mask_err"] = max(out["mask_err"], gap - allow)
        if uint8:
            want_code = np.round(np.clip(want, 0.0, 1.0) * 255.0)
            codes += want_code.size
            code_differ += int(np.count_nonzero(np.round(g * 255.0)
                                                != want_code))
    out["mask_code_share"] = code_differ / codes if codes else 0.0
    out["mask_class_share"] = class_differ / pixels if pixels else 0.0
    return {"numbers": out, "counts": n, "bad": bad}
