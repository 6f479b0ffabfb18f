"""Engine: the program's own decode steps that ran eagerly (its
``decode`` spans with ``graph`` 0) in the window's untraced part; on a
card a tenant's steps after its capture replay the graph."""


def read(rec):
    spans = rec.program_spans("decode")
    if not spans:
        return None
    return float(sum(e.detail["graph"] == 0 for e in spans))
