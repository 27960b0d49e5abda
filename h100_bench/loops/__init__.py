"""Traffic loops, one module each, found by a traffic mix's ``loop``:
``run(setup, due, inputs, sample)`` calls the program's entry on the
units of ``inputs`` (``(host frames [batch, H, W, 3], pool indices)``)
while ``due(k)`` holds for the ``k``-th, offers each unit's ``(pool
indices, answers a frame)`` to ``sample`` (a frame's answer is its list
of faces, or a dict of parts such as ``{"faces": [...], "mask": ...}``;
``harness/check.py``), and returns ``{"ends", "latencies", "units"}``:
each unit's end on the host clock, each call's latency where a unit is
one call, each unit's ``(pool indices, faces returned a frame)``."""
