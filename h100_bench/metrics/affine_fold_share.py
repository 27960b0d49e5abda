"""``affine_fold_share``: of the networks' per-channel affine pairs (a
4-D MUL by one constant a channel, then the ADD of one, a batch norm the
graph keeps) that ran on the card over the traced units' two runs, the
share that ran in K5's affine pass, in percent: the change of
``FaceDetector.memory_report()["affine_folded"]`` over that change plus
the change of ``["affine_op_by_op"]`` (pairs run as two PyTorch ops).
Replays count what their capture recorded.  None where the program
keeps no such count or none ran.  Layer: networks."""


def read(ctx):
    keys = ("affine_folded", "affine_op_by_op")
    if any(k not in ctx.memory_after or k not in ctx.memory_before
           for k in keys):
        return None
    folded, op_by_op = (ctx.memory_after[k] - ctx.memory_before[k]
                        for k in keys)
    total = folded + op_by_op
    return 100.0 * folded / total if total else None
