"""The comparison that decides ``correct``: the program's faces against the
plain reference's, frame by frame.

Numbers compared (each against the cell's limit in
``limits/<cell>.json``):

* ``face_mismatch``: frames whose face count differs (exact, limit 0);
* ``box_err``: largest gap of a box coordinate (normalised units);
* ``score_err``: largest gap of a detection score, or of a presence score
  where the face's mesh is compared;
* ``kp_err_px``: largest gap of a keypoint, the iris-refined eyes
  included, in image pixels;
* ``mesh_code_share``: share of the mesh and iris coordinates whose
  int16 readback code differs from the reference value's code (the
  program reads the landmarks back as int16 at ``32000 / (2 * max(H,
  W))`` codes a pixel; a code differs only where rounding lands a value
  on the other side of a code boundary, or the value is wrong);
* ``landmark_err_px``: largest gap of a mesh or iris coordinate beyond
  half a readback code (what the int16 rounding alone can explain);
* ``blend_err``: largest gap of a blendshape coefficient;
* ``angle_err_deg``: largest gap of a head angle (degrees, modulo 360);
* ``embed_err``: largest gap of an embedding component (configurations
  that embed).

Frames the reference calls ambiguous are not compared, and a face's
outputs that rounding may have sent down another path are not compared
(``reference/pipeline.py``); both are counted.
"""

from __future__ import annotations

import json
import os

import numpy as np

LIMITS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "limits")

NUMBERS = ("face_mismatch", "box_err", "score_err", "kp_err_px",
           "mesh_code_share", "landmark_err_px", "blend_err",
           "angle_err_deg", "embed_err")


def load_limits(workload: str) -> dict:
    """The limits of cell ``workload``: ``limits/<cell>.json``."""
    with open(os.path.join(LIMITS, workload + ".json")) as f:
        return json.load(f)["limits"]


def readback_scale(h: int, w: int) -> float:
    return 32000.0 / (2.0 * max(h, w))


def port_face(face) -> dict:
    """The outputs of one of the program's ``Face`` objects."""
    bs = face.blendshapes
    ang = face.head_euler_angles
    return {"box": np.asarray([face.bounding_box.xmin, face.bounding_box.ymin,
                               face.bounding_box.xmax,
                               face.bounding_box.ymax], np.float64),
            "score": float(face.score),
            "kp": np.asarray(face.detection_data.keypoints_xy, np.float64),
            "mesh": np.asarray(face.mesh.points, np.float64),
            "mesh_score": float(face.mesh.score),
            "iris": np.asarray(face.iris_points, np.float64),
            "bs": None if bs is None else np.asarray(face._blendshape_scores,
                                                     np.float64),
            "angles": (np.full(3, np.nan) if ang is None else
                       np.asarray([ang.x, ang.y, ang.z], np.float64)),
            "emb": (None if face.embedding is None
                    else np.asarray(face.embedding, np.float64))}


def _angle_gap(a, b) -> float:
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs((a - b + 180.0) % 360.0 - 180.0)
    d = np.where(both_nan, 0.0, d)
    return float(np.max(np.where(np.isnan(d), np.inf, d)))


def compare(pairs, h: int, w: int) -> dict:
    """``pairs``: [(program faces as dicts, reference frame dict)] of the
    sampled frames.  Returns the numbers and the frame counts."""
    scale = readback_scale(h, w)
    out = {k: 0.0 for k in NUMBERS}
    codes = differ = 0
    n = {"frames": len(pairs), "ambiguous": 0, "compared": 0, "faces": 0,
         "outputs_skipped": 0, "bad_frames": 0}
    for got, ref in pairs:
        if ref["why"]:
            n["ambiguous"] += 1
            continue
        n["compared"] += 1
        want = ref["faces"]
        if len(got) != len(want):
            out["face_mismatch"] += 1
            n["bad_frames"] += 1
            continue
        for g, r in zip(got, want):
            n["faces"] += 1
            n["outputs_skipped"] += len(r["skip"])
            out["box_err"] = max(out["box_err"], float(np.max(np.abs(
                g["box"] - r["box"]))))
            se = abs(g["score"] - r["score"])
            if "mesh" not in r["skip"]:
                se = max(se, abs(g["mesh_score"] - r["mesh_score"]))
            if se > out["score_err"]:
                out["score_err"] = se
                n["worst_score"] = {"det": abs(g["score"] - r["score"]),
                                    "gaps": r["gaps"], "skip": sorted(r["skip"])}
            kp_rows = slice(2, 6) if "eyes" in r["skip"] else slice(0, 6)
            px = np.asarray([w, h], np.float64)
            ke = np.abs((g["kp"][kp_rows] - r["kp"][kp_rows]) * px)
            if float(np.max(ke)) > out["kp_err_px"]:
                out["kp_err_px"] = float(np.max(ke))
                n["worst_kp"] = {"row": int(np.argmax(ke.max(1))) + kp_rows.start,
                                 "gaps": r["gaps"], "skip": sorted(r["skip"]),
                                 "size": [float(r["rois"][k][:, 2].max()) for k in sorted(r["rois"])]}
            for key in ("mesh", "iris"):
                if key in r["skip"]:
                    continue
                want_code = np.clip(np.round(r[key].astype(np.float64)
                                             * scale), -32767, 32767)
                got_code = np.round(g[key] * scale)
                codes += want_code.size
                differ += int(np.count_nonzero(got_code != want_code))
                out["landmark_err_px"] = max(out["landmark_err_px"], float(
                    np.max(np.abs(g[key] - r[key]))) - 0.5 / scale)
            if "bs" not in r["skip"]:
                if (g["bs"] is None) != (r["bs"] is None):
                    out["blend_err"] = max(out["blend_err"], 1.0)
                elif g["bs"] is not None:
                    out["blend_err"] = max(out["blend_err"], float(np.max(
                        np.abs(g["bs"] - r["bs"]))))
            if "angles" not in r["skip"]:
                out["angle_err_deg"] = max(out["angle_err_deg"], _angle_gap(
                    g["angles"], r["angles"].astype(np.float64)))
            if r["emb"] is not None and "emb" not in r["skip"]:
                e = 1.0 if g["emb"] is None else float(np.max(
                    np.abs(g["emb"] - r["emb"])))
                if e > out["embed_err"]:
                    out["embed_err"] = e
                    n["worst_embed_gaps"] = r["gaps"]
            elif r["emb"] is None and g["emb"] is not None:
                out["embed_err"] = max(out["embed_err"], 1.0)
    out["mesh_code_share"] = differ / codes if codes else 0.0
    return {"numbers": out, "counts": n}


def judge(numbers: dict, counts: dict, limits: dict, embeds: bool):
    """(correct, {name: {"value", "limit"}}) of the numbers this
    configuration compares."""
    names = [k for k in NUMBERS if embeds or k != "embed_err"]
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in names}
    ok = counts["compared"] > 0 and all(
        numbers[k] <= limits[k] for k in names)
    return ok, shown
