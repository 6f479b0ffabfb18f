"""Device: the share of the summed ``engine.step()`` wall of the traced
window in which no operation ran on the device."""


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    steps = sorted(s for s in rec.steps if tr.t0 <= s[0] and s[1] <= tr.t1)
    wall = sum(b - a for a, b in steps)
    if not wall:
        return None
    return 1.0 - tr.busy_within(steps) / wall
