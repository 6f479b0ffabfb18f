"""The plain float32 reference of the dense and MoE decoders the
benchmark runs: OLMoE (arXiv:2409.02060: pre-norm decoder, RoPE
attention, 64 GLU experts with softmax top-8 routing, dropless) and the
dense GQA decoder of granite-8b-code (arXiv:2405.04324: a Llama-style
block with a SwiGLU MLP and tied embeddings), with their weight layout
(every leaf stacked over layers).

Written from the published descriptions, in the port's conventions
where the port departs from them (each departure is listed in the
configuration's file, ``departures``): RMSNorm with eps 1e-6 and the
gain stored as 1 + g; RoPE rotating the two halves of a head; no q/k
norm (OLMoE has one); top-k gates renormalised to sum 1 (OLMoE's
``norm_topk_prob`` is false); no biases; logits over the vocabulary
padded to a multiple of ``vocab_pad_to``. Matrices multiply as ``x @
W`` with W (in, out).

Scales: matrices N(0, 1/fan_in), the router and the embeddings N(0,
0.02²), norm gains 1 + N(0, 0.1²) (the gain is stored as the offset from
1, as the program stores it)."""
from __future__ import annotations

import torch

from bench.reference.model import (causal_attention, glu, plain_mm,
                                   rms_norm, rope)
from bench.reference.weights import padded_vocab


def leaves(cfg: dict) -> list[tuple[str, tuple, float]]:
    """(name, shape, scale) of every leaf, in the order they are drawn."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KH, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    F, V = cfg["intermediate_size"], padded_vocab(cfg)
    out = [("embed", (V, D), 0.02)]
    if not cfg["tie_word_embeddings"]:
        out.append(("unembed", (D, V), 0.02))
    out += [("ln_f", (D,), 0.1), ("ln1", (L, D), 0.1), ("ln2", (L, D), 0.1),
            ("wq", (L, D, H * hd), D ** -0.5),
            ("wk", (L, D, KH * hd), D ** -0.5),
            ("wv", (L, D, KH * hd), D ** -0.5),
            ("wo", (L, H * hd, D), (H * hd) ** -0.5)]
    E = cfg.get("num_experts", 0)
    if E:
        out += [("router", (L, D, E), 0.02),
                ("w_gate", (L, E, D, F), D ** -0.5),
                ("w_up", (L, E, D, F), D ** -0.5),
                ("w_down", (L, E, F, D), F ** -0.5)]
    else:
        out += [("w_gate", (L, D, F), D ** -0.5),
                ("w_up", (L, D, F), D ** -0.5),
                ("w_down", (L, F, D), F ** -0.5)]
    return out


def moe(x, router, wg, wu, wd, k: int, mm):
    """Softmax over the experts, the top k (ties to the lower id), gates
    renormalised; each expert's GLU over the tokens routed to it."""
    probs = torch.softmax(mm(x, router), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(router.shape[1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = glu(x[tok], wg[e].float(), wu[e].float(), wd[e].float(), mm)
            out.index_add_(0, tok, y * gates[tok, slot, None])
    return out


@torch.no_grad()
def logits_at(cfg: dict, w: dict, tokens: torch.Tensor, at: torch.Tensor,
              mm=plain_mm) -> torch.Tensor:
    """Float32 logits (len(at), padded vocab) of ``tokens`` (S,) at the
    positions ``at``."""
    H, KH, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    x = w["embed"][tokens].float()
    S = x.shape[0]
    for i in range(cfg["num_hidden_layers"]):
        h = rms_norm(x, w["ln1"][i].float(), eps)
        q = rope(mm(h, w["wq"][i].float()).view(S, H, hd), theta)
        kk = rope(mm(h, w["wk"][i].float()).view(S, KH, hd), theta)
        v = mm(h, w["wv"][i].float()).view(S, KH, hd)
        a = causal_attention(q, kk, v).reshape(S, H * hd)
        x = x + mm(a, w["wo"][i].float())
        h = rms_norm(x, w["ln2"][i].float(), eps)
        if cfg.get("num_experts", 0):
            x = x + moe(h, w["router"][i].float(), w["w_gate"][i],
                        w["w_up"][i], w["w_down"][i],
                        cfg["num_experts_per_tok"], mm)
        else:
            x = x + glu(h, w["w_gate"][i].float(), w["w_up"][i].float(),
                        w["w_down"][i].float(), mm)
    h = rms_norm(x[at], w["ln_f"].float(), eps)
    head = (w["embed"].float().T if cfg["tie_word_embeddings"]
            else w["unembed"].float())
    return mm(h, head)
