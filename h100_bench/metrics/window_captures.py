"""``window_captures``: program keys captured during the window (the
change of ``FaceDetector.memory_report()["captured_keys"]``); 0 where the
warm-up captured every key the traffic reaches.  Layer: captured
programs."""


def read(ctx):
    return (ctx.memory_after["captured_keys"]
            - ctx.memory_before["captured_keys"])
