"""Engine: mean host wall of one tenant's decode step, up to the tokens
back on the host, in the window's untraced part."""


def read(rec):
    dec = rec.untraced(rec.decodes)
    if not dec:
        return None
    return 1e3 * sum(d[1] - d[0] for d in dec) / len(dec)
