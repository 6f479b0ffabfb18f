"""Model, MoE: the least time of the prefills' expert products (each
token's k experts, every expert's weights read once) over the device
time of the expert products (the kernels a ``torch.bmm`` call launched)
that prefills launched, in the traced window, as a percentage. A
prefill of T tokens routes T·k choices over the E experts; from 8·E
choices on (every prefill here) each expert's weights count whole."""
from bench.counts.moe import expert_products
from bench.counts.peaks import roofline_s


def read(rec):
    tr, cfg = rec.trace, rec.cfg
    if tr is None or not cfg.get("num_experts"):
        return None
    pre = [p for p in rec.prefills if tr.t0 <= p[0] < tr.t1]
    device = tr.device_in(pre, tr.launched_by_bmm)
    if not device:
        return None
    L, E = cfg["num_hidden_layers"], cfg["num_experts"]
    bound = sum(L * roofline_s(*expert_products(
        p[4], cfg["num_experts_per_tok"], cfg["hidden_size"],
        cfg["intermediate_size"], min(E, p[4] * cfg["num_experts_per_tok"])))
        for p in pre)
    return 100.0 * bound / device
