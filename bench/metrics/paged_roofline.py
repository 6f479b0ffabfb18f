"""Kernels: K5's roofline share over the traced window, as a percentage:
the bytes counted from each decode step's actual lengths (its active
rows), over the device time of the K5 kernels that those steps
launched; K5 runs in the layers that the architecture's
``attention_layers`` counts."""
from bench.counts.attention import paged_decode
from bench.counts.peaks import roofline_s


def read(rec):
    tr, cfg = rec.trace, rec.cfg
    if tr is None:
        return None
    dec = [d for d in rec.decodes if tr.t0 <= d[0] < tr.t1]
    device = tr.device_in(dec, lambda k: "paged_" in k.name)
    if not device:
        return None
    L = rec.arch.attention_layers(cfg)
    bound = sum(L * roofline_s(*paged_decode(
        d[3], cfg["num_attention_heads"], cfg["num_key_value_heads"],
        cfg["head_dim"])) for d in dec)
    return 100.0 * bound / device
