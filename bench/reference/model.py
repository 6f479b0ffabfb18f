"""Plain float32 forward passes of the two decoders the benchmark runs:
OLMoE (arXiv:2409.02060: pre-norm decoder, RoPE attention, 64 GLU
experts with softmax top-8 routing, dropless) and the dense GQA decoder
of granite-8b-code (arXiv:2405.04324: a Llama-style block with a SwiGLU
MLP and tied embeddings).

Written from the published descriptions, in the port's conventions
where the port departs from them (each departure is listed in the
configuration's file, ``departures``): RMSNorm with eps 1e-6 and the
gain stored as 1 + g; RoPE rotating the two halves of a head; no q/k
norm (OLMoE has one); top-k gates renormalised to sum 1 (OLMoE's
``norm_topk_prob`` is false); no biases; logits over the vocabulary
padded to a multiple of ``vocab_pad_to``. Matrices multiply as ``x @
W`` with W (in, out).

Every product goes through ``mm`` (default: float32 ``x @ W``), so the
control can put a lower precision in its place. Weights arrive in the
benchmark's layout (:mod:`bench.reference.weights`) in any dtype and
are taken to float32 a layer at a time."""
from __future__ import annotations

import torch

NEG_INF = float("-inf")


def plain_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def rms_norm(x, gain, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + gain)


def rope(x, theta: float):
    """x (S, heads, hd) at positions 0..S−1: the halves rotated."""
    S, _, hd = x.shape
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q, k, v, block: int = 1024):
    """q (S, H, hd), k/v (S, KH, hd), each query over keys 0..itself;
    queries in blocks so that the scores fit."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for s0 in range(0, S, block):
        qb = q[s0:s0 + block]
        s = torch.einsum("qhd,khd->hqk", qb, k) * hd ** -0.5
        qpos = s0 + torch.arange(qb.shape[0], device=q.device)
        s = s.masked_fill(kpos[None, None, :] > qpos[None, :, None], NEG_INF)
        out[s0:s0 + block] = torch.einsum("hqk,khd->qhd",
                                          torch.softmax(s, -1), v)
    return out


def glu(x, wg, wu, wd, mm):
    return mm(torch.nn.functional.silu(mm(x, wg)) * mm(x, wu), wd)


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


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's product: x per row and W per output column scaled
    into float8 e4m3, rounded there, and multiplied in float32."""
    def q(t, dim):
        s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s
    return q(x, -1) @ q(w, 0)
