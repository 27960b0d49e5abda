"""``idle_unspanned_share``: percent of the traced window's device-idle
time during which no thread of the host was inside any of the port's
``fdt.*`` spans or ranges (the idle time that no span names: the
caller's own code, the interpreter between spans).  Layer: device."""


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """Total length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    t = ctx.trace
    spans = _union((a, b) for a, b, n in t.host_ops if n.startswith("fdt."))
    if not spans:
        return None
    idle, at = [], t.t0
    for a, b in t.busy:
        if a > at:
            idle.append((at, min(a, t.t1)))
        at = max(at, b)
    if at < t.t1:
        idle.append((at, t.t1))
    idle = [(a, b) for a, b in idle if b > a]
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    return 100.0 * (total - _overlap(idle, spans)) / total
