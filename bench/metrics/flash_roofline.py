"""Kernels: K4's roofline share over the traced window, as a percentage:
the work counted from each prefill's length, over the device time of the
K4 kernels that those prefills launched; K4 runs in the layers that the
architecture's ``attention_layers`` counts."""
from bench.counts.attention import flash_prefill
from bench.counts.peaks import roofline_s


def read(rec):
    tr, cfg = rec.trace, rec.cfg
    if tr is None:
        return None
    pre = [p for p in rec.prefills if tr.t0 <= p[0] < tr.t1]
    device = tr.device_in(pre, lambda k: "flash_" in k.name)
    if not device:
        return None
    L = rec.arch.attention_layers(cfg)
    bound = sum(L * roofline_s(*flash_prefill(
        p[4], cfg["num_attention_heads"], cfg["num_key_value_heads"],
        cfg["head_dim"])) for p in pre)
    return 100.0 * bound / device
