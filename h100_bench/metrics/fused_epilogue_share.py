"""``fused_epilogue_share``: of the networks' PRELUs and ADDs with a
fused RELU that ran on the card over the traced units' two runs, the
share that ran in one residual-add-and-activation pass, K5, in percent:
the change of ``FaceDetector.memory_report()["epilogue_fused"]`` (K5's
launches, replays included) over that change plus the change of
``["epilogue_op_by_op"]`` (those that ran op by op).  None where the
program keeps no such count or none ran.  Layer: networks."""


def read(ctx):
    keys = ("epilogue_fused", "epilogue_op_by_op")
    if any(k not in ctx.memory_after or k not in ctx.memory_before
           for k in keys):
        return None
    fused, op_by_op = (ctx.memory_after[k] - ctx.memory_before[k]
                       for k in keys)
    total = fused + op_by_op
    return 100.0 * fused / total if total else None
