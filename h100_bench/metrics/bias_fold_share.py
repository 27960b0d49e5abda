"""``bias_fold_share``: of the float32 convolutions' biases added on the
card over the traced units' two runs, the share that a pass doing the
op after the convolution took (its PReLU, ReLU or residual add), in
percent: the change of ``FaceDetector.memory_report()["bias_folded"]``
over that change plus those of ``["bias_alone"]`` (a bias pass of its
own) and ``["bias_op_by_op"]`` (added by PyTorch).  Replays count what
their capture recorded.  None where the program keeps no such count or
none was added.  Layer: networks."""


def read(ctx):
    keys = ("bias_folded", "bias_alone", "bias_op_by_op")
    if any(k not in ctx.memory_after or k not in ctx.memory_before
           for k in keys):
        return None
    folded, alone, op_by_op = (ctx.memory_after[k] - ctx.memory_before[k]
                               for k in keys)
    total = folded + alone + op_by_op
    return 100.0 * folded / total if total else None
