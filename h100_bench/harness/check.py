"""The comparison that decides ``correct``: each check a configuration
lists under ``answers`` (``["faces"]`` where it lists none) compares the
program's answers with the plain reference's, frame by frame, and
:func:`judge` holds every number each reports to the cell's limit in
``limits/<cell>.json``.

A check is the module ``h100_bench/checks/<name>.py``, found by name.
It gives:

* ``NUMBERS``, the names of the numbers it may report, and
  ``names(config)``, those a configuration compares;
* ``reference(config, nets, device)``: its plain reference over the
  benchmark's networks, called as ``ref(frames, operands)`` on uint8
  frames ``[N, H, W, 3]`` and giving one dict a frame (``operands`` is
  the control's rounding of every convolution's and fully-connected
  layer's operands, None in a run);
* ``port_answer(answer, config)``: the program's answer for one frame in
  the form ``compare`` takes;
* ``as_program(ref_frame, frame_hw, config)``: a reference frame's
  answer in that same form, through the program's readback (the
  control's answers);
* ``compare(pairs, frame_hw, config)`` over ``[(answer, reference
  frame)]``: ``{"numbers", "counts", "bad"}``, ``counts["compared"]``
  the frames it compared and ``bad`` the pairs that fail an exact
  number.

A loop offers a frame's answer as a dict of parts (``{"faces": [...],
"mask": ...}``); a bare list of faces is the frame's ``{"faces": ...}``.
"""

from __future__ import annotations

import json
import os

from .manifest import plugin

LIMITS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "limits")


def modules(config: dict) -> list:
    """``[(name, module)]`` of the checks ``config`` lists."""
    return [(name, plugin("checks", name))
            for name in config.get("answers", ["faces"])]


def frame_answer(answer) -> dict:
    """A loop's answer for one frame as a dict of parts."""
    return answer if isinstance(answer, dict) else {"faces": answer}


def load_limits(workload: str) -> dict:
    """The limits of cell ``workload``: ``limits/<cell>.json``."""
    with open(os.path.join(LIMITS, workload + ".json")) as f:
        return json.load(f)["limits"]


def judge(results: dict, limits: dict, config: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers of every
    check ``config`` lists, in its order; ``results`` is ``{check:
    compare(...)}``.  Correct where every check compared a frame and no
    number passes its limit."""
    shown, ok = {}, True
    for name, mod in modules(config):
        res = results[name]
        ok = ok and res["counts"]["compared"] > 0
        for k in mod.names(config):
            shown[k] = {"value": res["numbers"][k], "limit": limits[k]}
            ok = ok and res["numbers"][k] <= limits[k]
    return ok, shown
