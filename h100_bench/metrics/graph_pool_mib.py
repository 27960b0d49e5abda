"""``graph_pool_mib``: MiB of the captured programs' memory pool at the
window's end (``FaceDetector.memory_report()["graph_pool_bytes"]``).
Layer: captured programs."""


def read(ctx):
    return ctx.memory_after["graph_pool_bytes"] / 2.0 ** 20
