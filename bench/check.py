"""The comparison that decides ``correct``.

After the window closes and the program's state is freed, a sample of
the requests the engine finished, drawn from the seed with the longest
one and up to two that were resumed after a preemption in it, is run
through the plain float32 reference of the configuration's architecture
(``logits_at`` of ``bench/reference/<arch>.py``) once each: the prompt
with its served tokens, teacher-forced. Every served token is greedy, so its
logit should be the reference's best at its position; the number
compared is the widest gap by which a served token's logit lies below
the reference's best, over the sample. The first served token comes
from the prefill (K4 and the MoE layer or the dense GLU), the rest from
decode steps through the KV cache (K5), and a resumed request's from
its re-prefill of prompt and generated tokens.

The control puts the reference in the program's place in float8 (e4m3)
products (:func:`bench.reference.model.fp8_mm`) and reads, at the same
positions, the gap of the token the control ranks first.

The number compared is the cell's choice (its traffic file's
``check.number``): ``max``, the widest gap, or ``mean``, the mean gap
over the sample's tokens (where bf16 flips near-ties of a MoE router,
the widest gap swings with the flips; see PERF.md). A cell whose quotas
move sets ``check.min_resumed`` (1 or 2), and a run that checked fewer
resumed requests is not correct."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from bench import modules
from bench.reference import weights as bw
from bench.reference.model import fp8_mm


def draw_sample(done: list[dict], rng: np.random.Generator,
                target_tokens: int, max_requests: int) -> list[dict]:
    """The longest finished request, up to two resumed ones, then others
    in an order drawn from ``rng`` until ``target_tokens`` served tokens
    or ``max_requests`` requests."""
    if not done:
        return []
    longest = max(done, key=lambda r: (r["prompt"] + r["generated"], r["rid"]))
    order = [done[i] for i in rng.permutation(len(done))]
    resumed = [r for r in order if r["resumed"] and r is not longest][:2]
    pick = [longest] + resumed
    for r in order:
        if (sum(x["generated"] for x in pick) >= target_tokens
                or len(pick) >= max_requests):
            break
        if all(r is not x for x in pick):
            pick.append(r)
    return pick


def gaps(ref, cfg: dict, w: dict, prompt: list[int], served: list[int],
         device, control: bool = False):
    """Per served token, the gap of its logit below the best of the
    reference ``ref`` (and, with ``control``, the gap of the token the
    control ranks first), as float32 tensors on the host."""
    toks = torch.tensor(prompt + served[:-1], dtype=torch.int64,
                        device=device)
    p, g = len(prompt), len(served)
    at = torch.arange(p - 1, p + g - 1, device=device)
    logits = ref.logits_at(cfg, w, toks, at)
    best = logits.max(-1).values
    tok = torch.tensor(served, dtype=torch.int64, device=device)
    gap = (best - logits.gather(1, tok[:, None])[:, 0]).cpu()
    if not control:
        return gap, None
    first = ref.logits_at(cfg, w, toks, at, mm=fp8_mm).argmax(-1)
    return gap, (best - logits.gather(1, first[:, None])[:, 0]).cpu()


def summary(g: torch.Tensor) -> dict:
    """The widest gap, the mean gap and the share of tokens that are not
    the reference's best, over a sample's tokens."""
    return {"max": float(g.max()), "mean": float(g.mean()),
            "mismatch": float((g > 0).float().mean())}


def compare(cfg: dict, sample: list[dict], seeds: list[int], device,
            control: bool = False, root: Path | None = None) -> dict:
    """The sample's gaps, one tenant's weights made at a time, against
    the reference of ``cfg``'s architecture in the checkout ``root``.
    Returns ``program`` (and ``control``) :func:`summary`, the requests,
    the served tokens and the resumed requests checked."""
    ref = modules.reference(cfg, root)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got, ctrl = [], []
    try:
        for tenant in sorted({r["tenant"] for r in sample}):
            w = bw.make(cfg, seeds[tenant], device, root)
            for r in (r for r in sample if r["tenant"] == tenant):
                gap, c = gaps(ref, cfg, w, r["tokens"], r["served"], device,
                              control)
                got.append(gap)
                if control:
                    ctrl.append(c)
            del w
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    empty = torch.zeros(1)
    out = {"program": summary(torch.cat(got) if got else empty),
           "requests": len(sample),
           "tokens": sum(len(r["served"]) for r in sample),
           "resumed": sum(bool(r["resumed"]) for r in sample)}
    if control:
        out["control"] = summary(torch.cat(ctrl) if ctrl else empty)
    return out
