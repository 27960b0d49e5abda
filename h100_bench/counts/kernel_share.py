"""The share of the launches that ran in a hand-written kernel where a
library could have run them: the change of one
``FaceDetector.memory_report()`` counter over the traced units' two runs,
over that change plus the change of the library's counter, in percent.
Replays count what their capture recorded."""


def kernel_share(ctx, kernel_key: str, library_key: str):
    """100 * d(kernel) / (d(kernel) + d(library)) over ``ctx``'s memory
    reports; None where either report lacks a key or neither count
    moved."""
    keys = (kernel_key, library_key)
    if any(k not in ctx.memory_after or k not in ctx.memory_before
           for k in keys):
        return None
    kernel, library = (ctx.memory_after[k] - ctx.memory_before[k]
                       for k in keys)
    total = kernel + library
    return 100.0 * kernel / total if total else None
