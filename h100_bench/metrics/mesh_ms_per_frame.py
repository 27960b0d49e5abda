"""``mesh_ms_per_frame``: device ms a frame of the mesh stage group (alignment, K2 at 192 px, FaceMesh, the transform)
inside the captured programs' replays: the differences of the program's
own stage stamps (the port's ``device.mesh`` timings, read back with
each call's results), over the traced units run once without the
profiler just before the traced window.  Layer: networks."""


def read(ctx):
    ms = ctx.timings.get("device.mesh", (0.0, 0))[0]
    frames = ctx.mix["trace_units"] * ctx.mix.get("batch", 1)
    return ms / frames if ms > 0 else None
