"""Model: wall of a fresh request's prefill (it ends by reading its
first token on the host) per 1,000 context tokens, in the window's
untraced part. Resumed re-prefills end without a read, so their walls
are left out."""


def read(rec):
    pre = [p for p in rec.untraced(rec.prefills) if not p[5]]
    tokens = sum(p[4] for p in pre)
    if not tokens:
        return None
    return 1e3 * sum(p[1] - p[0] for p in pre) / (tokens / 1e3)
