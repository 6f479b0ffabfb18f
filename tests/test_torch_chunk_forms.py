"""The chunk-parallel algebra of K6 (rwkv6) and K7 (ssd), on the CPU.

Each kernel cuts the sequence into chunks of 64 steps and runs three
phases: chunk summaries (each chunk's state update from a zero state),
a sequential pass of the state over the chunks, and each chunk's output
from its start state. Here each decomposition
is written as a short f64 torch function, padded as the kernels mask a
ragged last chunk, and held to the plain version (the oracle the kernels
are held to on the card) at 1e-10: an error in the design's algebra shows
here, without a card."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import rwkv6 as K6
from repro_torch.kernels import ssd as K7

L = 64      # the kernels' chunk
TOL = dict(rtol=1e-10, atol=1e-10)


def _f64(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape))


def ssd_three_phase(x, dt, a_log, Bm, Cm, init_state=None):
    """K7's phases: per chunk S_c = Σ_j x_j ⊗ (dt_j·exp(cum_end − cum_j)
    ·B_j) and γ_c = exp(cum_end); S_prev(c+1) = γ_c·S_prev(c) + S_c;
    y = exp(cum)·(C·S_prevᵀ) + (M ⊙ dt_j)·x with M = (C·Bᵀ) ⊙ exp(cum_i −
    cum_j), causal. Past the end dt = x = B = C = 0."""
    B, H, T, P = x.shape
    N = Bm.shape[-1]
    nc = -(-T // L)
    pad = nc * L - T
    xc = F.pad(x, (0, 0, 0, pad)).reshape(B, H, nc, L, P)
    dtc = F.pad(dt, (0, pad)).reshape(B, H, nc, L)
    Bc = F.pad(Bm, (0, 0, 0, pad)).reshape(B, nc, L, N)
    Cc = F.pad(Cm, (0, 0, 0, pad)).reshape(B, nc, L, N)
    cum = torch.cumsum(dtc * -torch.exp(a_log)[None, :, None, None], -1)
    # (a) chunk-local, from a zero state
    w1 = dtc * torch.exp(cum[..., -1:] - cum)
    S_c = torch.einsum("bhclp,bhcl,bcln->bhcpn", xc, w1, Bc)
    gamma = torch.exp(cum[..., -1])
    # (b) the state pass
    s = (torch.zeros((B, H, P, N), dtype=x.dtype) if init_state is None
         else init_state)
    starts = []
    for c in range(nc):
        starts.append(s)
        s = gamma[:, :, c, None, None] * s + S_c[:, :, c]
    # (c) the output: intra-chunk products and the inter-chunk term
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    decay = torch.exp(torch.where(causal, cum[..., :, None]
                                  - cum[..., None, :], float("-inf")))
    M = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, None] * decay \
        * dtc[..., None, :]
    y = torch.einsum("bhcij,bhcjp->bhcip", M, xc) + torch.exp(cum)[..., None] \
        * torch.einsum("bcin,bhcpn->bhcip", Cc, torch.stack(starts, 2))
    return y.reshape(B, H, nc * L, P)[:, :, :T], s


def rwkv6_three_phase(r, k, v, w, u, init_state=None):
    """K6's phases: per chunk ΔS_c = (k ⊙ E)ᵀ·v with the suffix products
    E_s = Π_{τ>s} w_τ, and P_end = Π w; S(c+1) = diag(P_end)·S(c) + ΔS_c;
    then the recurrence over each chunk from its start state S(c). Past
    the end r = k = v = 0 and w = 1."""
    B, H, T, K = r.shape
    nc = -(-T // L)
    pad = nc * L - T
    rc, kc, vc = (F.pad(t, (0, 0, 0, pad)).reshape(B, H, nc, L, K)
                  for t in (r, k, v))
    wc = F.pad(w, (0, 0, 0, pad), value=1.0).reshape(B, H, nc, L, K)
    # (a) chunk summaries, no recurrence: E_s = Π_{τ>s} w_τ ≤ 1
    suffix = torch.flip(torch.cumprod(torch.flip(wc, [-2]), -2), [-2])
    E = torch.cat([suffix[..., 1:, :], torch.ones_like(wc[..., :1, :])], -2)
    dS = torch.einsum("bhcsk,bhcsv->bhckv", kc * E, vc)
    p_end = suffix[..., 0, :]
    # (b) the state pass
    s = (torch.zeros((B, H, K, K), dtype=r.dtype) if init_state is None
         else init_state)
    starts = []
    for c in range(nc):
        starts.append(s)
        s = p_end[:, :, c, :, None] * s + dS[:, :, c]
    # (c) the recurrence inside every chunk at once, from its start state
    S = torch.stack(starts, 2)
    o = []
    for t in range(L):
        kv = kc[..., t, :, None] * vc[..., t, None, :]
        o.append(torch.einsum("bhck,bhckv->bhcv", rc[..., t, :],
                              S + u[None, :, None, :, None] * kv))
        S = wc[..., t, :, None] * S + kv
    return torch.stack(o, -2).reshape(B, H, nc * L, K)[:, :, :T], s


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("T,dt_shift", [(1, 0.0), (63, 0.0), (64, 0.0),
                                        (65, 0.0), (200, 0.0),
                                        (150, 50.0)])
def test_ssd_three_phases_match_plain(T, dt_shift, init):
    """dt_shift 50: exp(cum) underflows to 0 within a few steps."""
    rng = np.random.default_rng(T + int(init))
    B, H, P, N = 2, 3, 8, 16
    x = _f64(rng, B, H, T, P)
    dt = F.softplus(_f64(rng, B, H, T)) + dt_shift
    a_log = _f64(rng, H) * 0.5
    Bm, Cm = _f64(rng, B, T, N), _f64(rng, B, T, N)
    s0 = _f64(rng, B, H, P, N) if init else None
    y, s = ssd_three_phase(x, dt, a_log, Bm, Cm, s0)
    want_y, want_s = K7.ssd_forward_plain(x, dt, a_log, Bm, Cm, chunk=T,
                                          init_state=s0)
    if dt_shift:
        assert float(torch.exp(torch.cumsum(dt[0, 0, :L] * -torch.exp(
            a_log[0]), 0))[-1]) == 0.0
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(s, want_s, **TOL)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("T,decay", [(1, None), (63, None), (64, None),
                                     (65, None), (200, None), (130, -8.0),
                                     (130, 8.0)])
def test_rwkv6_three_phases_match_plain(T, decay, init):
    """decay -8: w ≈ sigmoid(-8), P_t underflows toward 0; +8: w near 1."""
    rng = np.random.default_rng(T + int(init))
    B, H, K = 2, 2, 16
    r, k, v = (_f64(rng, B, H, T, K) for _ in range(3))
    w = torch.sigmoid(_f64(rng, B, H, T, K) * (0.1 if decay else 1.0)
                      + (decay or 0.0))
    u = _f64(rng, H, K)
    s0 = _f64(rng, B, H, K, K) if init else None
    o, s = rwkv6_three_phase(r, k, v, w, u, s0)
    want_o, want_s = K6.rwkv6_forward_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(o, want_o, **TOL)
    torch.testing.assert_close(s, want_s, **TOL)
