"""Priority management (paper §3): SPM baseline + three DPM approaches.

Scalar forms follow Eqs. 2–6 exactly (weights all 1.0 per §5 Setup).
A vectorised torch scorer is provided for large tenant counts — the
paper's "lightweight" claim hinges on O(N) rounds; the vector form makes
the score update a handful of fused vector ops on-device if desired.

Reciprocal terms: Eq. 4 and Eq. 6 divide by workload/scale factors. The
paper leaves x=0 undefined; we use 1/(W·max(x,1)) so a never-scaled
server receives the maximum bonus rather than an infinity.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import PricingModel, TenantState, Weights

POLICIES = ("sps", "wdps", "cdps", "sdps")


def _recip(w: float, x: float) -> float:
    return 1.0 / (w * max(x, 1.0))


def sps(state: TenantState, w: Weights = Weights()) -> float:
    """Eq. 2: static priority — premium, FCFS, ageing, loyalty."""
    return (w.W_P * state.spec.premium
            + w.W_ID / max(state.ordinal, 1)
            + w.W_Age * state.age
            + w.W_Loyalty * state.loyalty)


def wdps(state: TenantState, requests: float, users: float, data_mb: float,
         w: Weights = Weights()) -> float:
    """Eq. 3 (PFR/Hybrid: additive) / Eq. 4 (PFP: reciprocal penalty)."""
    base = sps(state, w)
    if state.spec.pricing in (PricingModel.PFR, PricingModel.HYBRID):
        return (base + w.W_Request * requests + w.W_U * users
                + w.W_Data * data_mb)
    return (base + _recip(w.W_Request, requests) + _recip(w.W_U, users)
            + _recip(w.W_Data, data_mb))


def cdps(state: TenantState, requests: float, users: float, data_mb: float,
         w: Weights = Weights()) -> float:
    """Eq. 5: community-aware — reward donated resources."""
    return wdps(state, requests, users, data_mb, w) + w.W_Reward * state.reward_count


def sdps(state: TenantState, requests: float, users: float, data_mb: float,
         w: Weights = Weights()) -> float:
    """Eq. 6: system-aware — penalise frequent scalers (reciprocal bonus
    shrinks as Scale_s grows)."""
    return (cdps(state, requests, users, data_mb, w)
            + _recip(w.W_Scale, state.scale_count))


def priority_score(policy: str, state: TenantState, requests: float,
                   users: float, data_mb: float, w: Weights = Weights()) -> float:
    if policy == "sps":
        return sps(state, w)
    if policy == "wdps":
        return wdps(state, requests, users, data_mb, w)
    if policy == "cdps":
        return cdps(state, requests, users, data_mb, w)
    if policy == "sdps":
        return sdps(state, requests, users, data_mb, w)
    raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")


# ---------------------------------------------------------------- vectorised
def batch_scores_np(policy: str, premium, ordinal, age, loyalty, requests,
                    users, data_mb, reward, scale_count, pfp_mask,
                    w: Weights = Weights()) -> np.ndarray:
    """NumPy scorer BITWISE-identical to ``priority_score`` per element.

    Every term is evaluated in the same order, with the same float64
    ops, as the scalar Eqs. 2–6 above — only the per-tenant Python loop
    is replaced by elementwise array arithmetic. This is what
    ``DyverseController.update_priorities`` runs each round, so it must
    never drift from the scalar reference (pinned by the priority
    regression tests)."""
    premium = np.asarray(premium, np.float64)
    ordinal = np.asarray(ordinal, np.int64)
    age = np.asarray(age, np.int64)
    loyalty = np.asarray(loyalty, np.int64)
    base = (w.W_P * premium + w.W_ID / np.maximum(ordinal, 1)
            + w.W_Age * age + w.W_Loyalty * loyalty)
    if policy == "sps":
        return base
    req = np.asarray(requests, np.float64)
    usr = np.asarray(users, np.float64)
    dat = np.asarray(data_mb, np.float64)
    add = base + w.W_Request * req + w.W_U * usr + w.W_Data * dat
    rec = (base + 1.0 / (w.W_Request * np.maximum(req, 1.0))
           + 1.0 / (w.W_U * np.maximum(usr, 1.0))
           + 1.0 / (w.W_Data * np.maximum(dat, 1.0)))
    score = np.where(np.asarray(pfp_mask, bool), rec, add)
    if policy == "wdps":
        return score
    score = score + w.W_Reward * np.asarray(reward, np.int64)
    if policy == "cdps":
        return score
    scl = np.asarray(scale_count, np.float64)
    return score + 1.0 / (w.W_Scale * np.maximum(scl, 1.0))


def batch_scores(policy: str, premium, ordinal, age, loyalty, requests, users,
                 data_mb, reward, scale_count, pfp_mask,
                 w: Weights = Weights(), *, device="cuda") -> torch.Tensor:
    """Vectorised scorer over N tenants (float32 torch tensors on
    ``device``). Semantics identical to the scalar form; used by the
    overhead benchmark at large N."""
    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    base = (w.W_P * f32(premium)
            + w.W_ID / torch.clamp(f32(ordinal), min=1.0)
            + w.W_Age * f32(age)
            + w.W_Loyalty * f32(loyalty))
    if policy == "sps":
        return base
    req, usr, dat = f32(requests), f32(users), f32(data_mb)
    add = w.W_Request * req + w.W_U * usr + w.W_Data * dat
    rec = (1.0 / (w.W_Request * torch.clamp(req, min=1.0))
           + 1.0 / (w.W_U * torch.clamp(usr, min=1.0))
           + 1.0 / (w.W_Data * torch.clamp(dat, min=1.0)))
    pfp = torch.as_tensor(np.asarray(pfp_mask, bool), device=device)
    score = base + torch.where(pfp, rec, add)
    if policy == "wdps":
        return score
    score = score + w.W_Reward * f32(reward)
    if policy == "cdps":
        return score
    return score + 1.0 / (w.W_Scale * torch.clamp(f32(scale_count), min=1.0))


# ---------------------------------------------------------------- normalized
def batch_scores_normalized(policy: str, premium, ordinal, age, loyalty,
                            requests, users, data_mb, reward, scale_count,
                            pfp_mask, w: Weights = Weights()):
    """BEYOND-PAPER: max-normalised factors.

    With the paper's all-equal weights, Request_s (~10³) numerically swamps
    the reward (≤ a few) and 1/Scale_s (≤ 1) terms, so cDPS/sDPS degenerate
    to wDPS — which the paper itself observes ("different approaches did
    not affect the overall violation rate", §5.1.2). The paper's stated
    future work is weighting the factors; here every factor is normalised
    to [0,1] across tenants before the linear combination, which makes the
    community/system terms mechanically comparable to the workload terms.
    """
    def norm(x):
        x = np.asarray(x, np.float64)
        m = x.max()
        return x / m if m > 0 else x

    base = (w.W_P * norm(premium) + w.W_ID * norm(1.0 / np.maximum(ordinal, 1))
            + w.W_Age * norm(age) + w.W_Loyalty * norm(loyalty))
    if policy == "sps":
        return base
    workload = (w.W_Request * norm(requests) + w.W_U * norm(users)
                + w.W_Data * norm(data_mb))
    pfp = np.asarray(pfp_mask, bool)
    n_work = 3.0 - workload  # reciprocal analogue in normalised space
    score = base + np.where(pfp, n_work, workload)
    if policy == "wdps":
        return score
    score = score + w.W_Reward * norm(reward)
    if policy == "cdps":
        return score
    inv_scale = 1.0 / np.maximum(np.asarray(scale_count, np.float64), 1.0)
    return score + w.W_Scale * norm(inv_scale)
