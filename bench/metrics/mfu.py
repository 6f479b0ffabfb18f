"""Device: model FLOPs the traced window's steps needed (prefills at
their lengths, decode rows at theirs, active experts only: the
architecture's ``prefill_flops`` and ``decode_flops``) over the summed
``engine.step()`` wall at the bf16 peak, as a percentage."""
from bench.counts.peaks import BF16_FLOPS_PER_S


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    steps = [s for s in rec.steps if tr.t0 <= s[0] and s[1] <= tr.t1]
    wall = sum(b - a for a, b in steps)
    if not wall:
        return None
    lo, hi = steps[0][0], steps[-1][1]
    arch = rec.arch
    flops = sum(arch.prefill_flops(rec.cfg, p[4]) for p in rec.prefills
                if lo <= p[0] < hi)
    flops += sum(arch.decode_flops(rec.cfg, d[3]) for d in rec.decodes
                 if lo <= d[0] < hi)
    return 100.0 * flops / (wall * BF16_FLOPS_PER_S)
