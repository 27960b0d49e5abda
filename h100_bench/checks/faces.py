"""``faces``: the program's faces against the plain reference's, frame by
frame.

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
(``reference/pipeline.py``); both are counted.  The reference is the
configuration's ``reference`` over the face roles.

A frame's faces come in descending score order.  Where the reference's
scores of faces that do not interact lie within ``EPS_SCORE`` of each
other, rounding may order them either way, so the program's faces are
paired with the reference's within each such run by their boxes
(:func:`in_reference_order`); every face is still compared.
"""

from __future__ import annotations

import numpy as np

from h100_bench.harness.manifest import plugin
from h100_bench.reference.pipeline import EPS_SCORE

NUMBERS = ("face_mismatch", "box_err", "score_err", "kp_err_px",
           "mesh_code_share", "landmark_err_px", "blend_err",
           "angle_err_deg", "embed_err")

#: The roles of the face pipeline, and the one a FULL call may add.
FACE_ROLES = ("detector", "mesh", "iris", "blendshapes")
EMBEDDING = "embedding"


def names(config: dict) -> list[str]:
    """The numbers ``config`` compares: ``embed_err`` where it embeds."""
    embeds = bool(config["networks"].get(EMBEDDING))
    return [k for k in NUMBERS if embeds or k != "embed_err"]


def reference(config: dict, nets: dict, device,
              roles=FACE_ROLES + (EMBEDDING,)):
    """The configuration's plain face pipeline over ``nets``' ``roles``."""
    return plugin("reference", config["reference"]).Reference(
        {r: nets[r] for r in roles if r in nets}, device,
        config["max_faces"])


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


def port_answer(answer: dict, config: dict) -> list[dict]:
    """A frame's faces as :func:`compare` takes them."""
    return [port_face(f) for f in answer["faces"]]


def as_program(frame: dict, frame_hw, config: dict) -> list[dict]:
    """A reference frame's faces in the form the program's answers take:
    the landmarks through the int16 readback's rounding."""
    scale = readback_scale(*frame_hw)
    out = []
    for f in frame["faces"]:
        q = {k: np.round(f[k].astype(np.float64) * scale) / scale
             for k in ("mesh", "iris")}
        out.append({"box": f["box"].astype(np.float64), "score": f["score"],
                    "kp": f["kp"].astype(np.float64),
                    "mesh_score": f["mesh_score"],
                    "bs": None if f["bs"] is None else f["bs"].astype(
                        np.float64),
                    "angles": f["angles"].astype(np.float64),
                    "emb": None if f["emb"] is None else f["emb"].astype(
                        np.float64), **q})
    return out


def _angle_gap(a, b) -> float:
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs((a - b + 180.0) % 360.0 - 180.0)
    d = np.where(both_nan, 0.0, d)
    return float(np.max(np.where(np.isnan(d), np.inf, d)))


def in_reference_order(got: list, want: list) -> tuple[list, int]:
    """The program's faces ``got`` paired with the reference's ``want``
    (as many): within each run of reference faces whose neighbours'
    scores lie within ``EPS_SCORE``, the pairs of the run's positions
    are taken nearest boxes first.  Returns the program's faces in the
    reference's order and how many moved."""
    out, moved, i = list(got), 0, 0
    while i < len(want):
        j = i + 1
        while j < len(want) and (float(want[j - 1]["score"])
                                 - float(want[j]["score"])) < EPS_SCORE:
            j += 1
        if j - i > 1:
            cost = np.asarray([[np.max(np.abs(got[q]["box"] - want[p]["box"]))
                                for q in range(i, j)] for p in range(i, j)])
            rows, cols = set(), set()
            for flat in np.argsort(cost, axis=None, kind="stable"):
                p, q = divmod(int(flat), j - i)
                if p in rows or q in cols:
                    continue
                rows.add(p)
                cols.add(q)
                out[i + p] = got[i + q]
                moved += p != q
        i = j
    return out, moved


def compare(pairs, frame_hw, config: dict) -> dict:
    """``pairs``: [(program faces as dicts, reference frame dict)] of the
    sampled frames.  Returns the numbers, the frame counts and ``bad``,
    the pairs that fail the exact number."""
    h, w = frame_hw
    scale = readback_scale(h, w)
    out = {k: 0.0 for k in NUMBERS}
    codes = differ = 0
    bad = []
    n = {"frames": len(pairs), "ambiguous": 0, "compared": 0, "faces": 0,
         "outputs_skipped": 0, "bad_frames": 0, "reordered": 0}
    for p, (got, ref) in enumerate(pairs):
        if ref["why"]:
            n["ambiguous"] += 1
            continue
        n["compared"] += 1
        want = ref["faces"]
        if len(got) != len(want):
            out["face_mismatch"] += 1
            n["bad_frames"] += 1
            bad.append(p)
            continue
        got, moved = in_reference_order(got, want)
        n["reordered"] += moved
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
    return {"numbers": out, "counts": n, "bad": bad}
