"""The port's MoE, encoder-decoder and vision-stub families against the
JAX package on the same weights (CPU, reduced configs).

Tolerances: ``moe_ffn`` in float32 within 1e-4 of the reference's, the
same (token, choice) pairs dropped at capacity, and the load-balance
loss within 1e-6; the models' logits through the shared harness
(``torch_lm_parity``) as for the dense decoder — float32 within 1e-4
with equal greedy streams, bfloat16 within 5e-2 on teacher-forced
tokens. A mixed engine of MoE and encoder-decoder tenants must give the
reference engine's outcomes and token streams exactly, through a
preemption and its resume."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as RM
from repro.configs import get_reduced as ref_reduced
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import MultiTenantEngine as RefEngine
from repro_torch.configs import get_reduced
from repro_torch.core import Quota, TenantSpec
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import moe as PM
from repro_torch.models.kvcache import grow_cache
from repro_torch.serving import EngineConfig, MultiTenantEngine, VirtualClock
from repro_torch.serving.request import Phase
from torch_lm_parity import models, port_batch, prompt, run, t

FAMILY_ARCHS = ("olmoe-1b-7b", "arctic-480b", "whisper-small")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- moe_ffn
def _moe_pair(arch, seed=0, **kw):
    """(reference cfg, port cfg, reference params, the port's MoE on the
    same weights), float32."""
    rcfg = ref_reduced(arch, dtype="float32", **kw)
    pcfg = get_reduced(arch, dtype="float32", **kw)
    rp = RM.moe_params(jax.random.key(seed), rcfg)
    flat = {}
    for name, a in rp.items():
        if isinstance(a, dict):
            flat.update({f"{name}.{k}": t(np.asarray(v)) for k, v in a.items()})
        else:
            flat[name] = t(np.asarray(a))
    pm = PM.MoE(pcfg, torch.Generator().manual_seed(0), "cpu")
    pm.load_state_dict(flat)
    return rcfg, pcfg, rp, pm


def _ref_dropped(rp, x, cfg):
    """The (token, choice) pairs the reference's dispatch drops: its
    router and its stable argsort (``moe.py:62-82``), in jnp."""
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    E, k = cfg.num_experts, cfg.experts_per_token
    _, idx, _ = RM.router_topk(jnp.asarray(x).reshape(T, D) @ rp["router"], k)
    C = T if T <= 4096 else int(max(1, round(T * k / E *
                                               cfg.capacity_factor)))
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.zeros((E,), jnp.int32).at[se].add(1)
    pos = jnp.arange(T * k) - (jnp.cumsum(counts) - counts)[se]
    order = np.asarray(order)
    return {(int(o) // k, int(o) % k) for o in order[np.asarray(pos) >= C]}


@pytest.mark.parametrize("arch,B,S,strategy,shift", [
    ("olmoe-1b-7b", 2, 16, "ep", 0.0),      # dropless (T ≤ 4,096)
    ("olmoe-1b-7b", 2, 16, "tp", 0.0),      # moe_ffn_tp without a mesh
    ("olmoe-1b-7b", 2, 2080, "ep", 3.0),    # T = 4,160: capacity drops
    ("arctic-480b", 2, 16, "ep", 0.0),      # dense residual
])
def test_moe_ffn_matches_reference(arch, B, S, strategy, shift):
    """``shift`` moves every input feature off zero, so the router
    favours some experts and, past 4,096 tokens, they overflow."""
    rcfg, pcfg, rp, pm = _moe_pair(arch, moe_strategy=strategy)
    x = (np.random.default_rng(S).standard_normal((B, S, pcfg.d_model))
         + shift).astype(np.float32)
    r_out, r_aux = RM.moe_ffn(rp, jnp.asarray(x), rcfg)
    p_out, p_aux = PM.moe_ffn(pm, t(x), pcfg)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), rtol=1e-4,
                               atol=1e-4)
    assert abs(float(p_aux) - float(r_aux)) <= 1e-6

    T, k = B * S, pcfg.experts_per_token
    _, idx, _ = PM.router_topk(t(x).reshape(T, -1) @ pm.router, k)
    order, _, valid = PM.dispatch(idx, pcfg.num_experts,
                                  PM.capacity(pcfg, T))
    dropped = {(int(o) // k, int(o) % k) for o in order[~valid]}
    assert dropped == _ref_dropped(rp, x, rcfg)
    assert bool(dropped) == (T > PM.DROPLESS_TOKENS)


def test_moe_ffn_matches_dense_reference_when_no_drop():
    """``tests/test_models.py``'s case against the reference's O(T·E)
    oracle ``moe_ffn_dense_reference``, run on the port."""
    rcfg, pcfg, rp, pm = _moe_pair("olmoe-1b-7b", seed=3,
                                   capacity_factor=8.0)
    x = np.asarray(jax.random.normal(jax.random.key(4),
                                     (2, 16, pcfg.d_model), jnp.float32))
    out, aux = PM.moe_ffn(pm, t(x), pcfg)
    ref = RM.moe_ffn_dense_reference(rp, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert float(aux) > 0


def test_moe_combine_sums_choices_in_a_fixed_order():
    """Two calls give the same bits (the combine is no scatter-add), and
    bf16 stays within bf16 rounding of the f32 result."""
    _, pcfg, _, pm = _moe_pair("olmoe-1b-7b")
    x = t(np.random.default_rng(2).standard_normal(
        (2, 16, pcfg.d_model)).astype(np.float32))
    a, _ = PM.moe_ffn(pm, x, pcfg)
    b, _ = PM.moe_ffn(pm, x, pcfg)
    assert torch.equal(a, b)
    bcfg = dataclasses.replace(pcfg, dtype="bfloat16")
    pb = PM.MoE(bcfg, torch.Generator().manual_seed(0), "cpu")
    pb.load_state_dict(pm.state_dict())
    c, _ = PM.moe_ffn(pb, x.bfloat16(), bcfg)
    assert float((c.float() - a).abs().max()) <= 5e-2 * float(a.abs().max())


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("arch", FAMILY_ARCHS + ("llava-next-34b",))
def test_family_logits_match_reference_f32(arch):
    """olmoe (64 → 4 experts, top-2), arctic (dense residual), whisper
    (encoder over seeded frames, cross attention, cross cache), and
    llava prefilled from seeded ``embeds`` then decoded from tokens (a
    case the reference's own tests skip)."""
    out = run(arch, "float32")
    for r, p in zip(out["ref"], out["port"]):
        np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-4)
    assert [x.tolist() for x in out["port_tok"]] == \
        [x.tolist() for x in out["ref_tok"]]


@contextlib.contextmanager
def _routing_log():
    """Each package's router choices, call by call (a call a MoE layer),
    and for the port's the gap between each token's k-th and (k+1)-th
    probability relative to the k-th."""
    port, ref = [], []
    p_topk, r_topk = PM.router_topk, RM.router_topk

    def p_hook(logits, k):
        gates, idx, probs = p_topk(logits, k)
        top = torch.sort(probs, dim=-1, descending=True).values
        port.append((idx.sort(dim=-1).values.numpy(),
                     ((top[:, k - 1] - top[:, k]) / top[:, k - 1]).numpy()))
        return gates, idx, probs

    def r_hook(logits, k):
        gates, idx, probs = r_topk(logits, k)
        jax.debug.callback(lambda i: ref.append(np.sort(np.asarray(i), -1)),
                           idx, ordered=True)
        return gates, idx, probs

    PM.router_topk, RM.router_topk = p_hook, r_hook
    try:
        yield port, ref
    finally:
        PM.router_topk, RM.router_topk = p_topk, r_topk


@pytest.mark.parametrize("arch", FAMILY_ARCHS + ("llava-next-34b",))
def test_family_logits_match_reference_bf16(arch):
    """Every step within 5e-2 of the reference, except that a MoE step in
    which the two routers chose other experts is exempt when each such
    choice was a near-tie: the k-th and (k+1)-th probabilities within
    2^-6 of each other, a gap the bf16 rounding of the router's inputs
    can close. Routing is discontinuous there: a flip moves the logits by
    more than 5e-2 (arctic, once in these 9 steps). At most one step may
    be exempt."""
    forced = np.random.default_rng(1).integers(0, 256, (8, 2))
    with _routing_log() as (port, ref):
        out = run(arch, "bfloat16", forced=forced)
    L = get_reduced(arch).num_layers
    flipped = set()
    for call, ((p_idx, gap), r_idx) in enumerate(zip(port, ref)):
        rows = (p_idx != r_idx).any(-1)
        assert (gap[rows] < 2.0 ** -6).all(), (call, gap[rows])
        if rows.any():
            flipped.add(call // L)
    assert len(port) == len(ref) == (len(out["ref"]) * L
                                     if get_reduced(arch).family == "moe"
                                     else 0)
    assert len(flipped) <= 1
    for step, (r, p) in enumerate(zip(out["ref"], out["port"])):
        if step not in flipped:
            assert np.abs(p - r).max() <= 5e-2, step


def test_params_from_jax_names_the_encoder_decoder_tree():
    *_, pcfg, _, pparams = models("whisper-small", "bfloat16")
    assert pparams.frontend_proj.shape == (pcfg.d_model, pcfg.d_model)
    assert pparams.frontend_proj.dtype == torch.bfloat16
    assert len(pparams.enc_layers) == pcfg.num_encoder_layers
    assert not hasattr(pparams.enc_layers[0], "cross")
    assert pparams.layers[0].cross.wq.dtype == torch.bfloat16
    assert pparams.ln_enc.bias.dtype == torch.float32
    *_, acfg, _, aparams = models("arctic-480b", "bfloat16")
    moe = aparams.layers[0].moe
    assert moe.w_down.shape == (acfg.num_experts, acfg.d_ff, acfg.d_model)
    assert moe.dense.w_up.dtype == torch.bfloat16


# ---------------------------------------------------------------- engine
MIXED = (("moe", "olmoe-1b-7b"), ("asr", "whisper-small"))


def _engine_cfg():
    return dict(policy="none", slot_cap=2, capacity_slots=4,
                capacity_pages=64, max_seq_len=64,
                round_interval_steps=10**9)


def _mixed_run(make_engine, weights, preempt: bool):
    """Two requests to each tenant on a virtual clock; with ``preempt``
    the MoE tenant's quota drops to 0 slots after 3 steps and comes
    back 3 steps later. Returns each request's (tenant, generated,
    first token t, finish t) and the MoE request's stream at the
    preemption."""
    clock, eng, done = make_engine()
    for name, params in weights.items():
        eng.tenants[name].params = params
    rng = np.random.default_rng(4)
    reqs = [eng.submit(name, [int(x) for x in rng.integers(1, 200, 6 + i)],
                       max_new_tokens=8)
            for i in range(2) for name, _ in MIXED]
    mid = None
    for step in range(200):
        if preempt and step == 3:
            mid = list(reqs[0].generated)
            eng.ctrl.actuator.apply_quota("moe", Quota(slots=0, pages=64))
        if preempt and step == 6:
            eng.ctrl.actuator.apply_quota("moe", Quota(slots=2, pages=64))
        if all(done(r) for r in reqs):
            break
        clock.tick()
        eng.step()
    return [(r.req.tenant, list(r.generated), r.first_token_t, r.finish_t)
            for r in reqs], mid


def test_mixed_engine_with_preemption_matches_reference():
    """Reduced olmoe and whisper tenants (weights carried from the
    reference; zero frames, as the engine feeds them): the port's engine
    gives the reference engine's outcomes — streams, first-token and
    finish times on the virtual clock — with and without a preemption,
    and the resumed MoE stream continues the unpreempted one exactly."""
    ref_w, port_w = {}, {}
    for name, arch in MIXED:
        _, _, rparams, _, _, pparams = models(arch, "float32", seed=5)
        ref_w[name], port_w[name] = rparams, pparams

    def port_engine():
        clock = VirtualClock(0.25)
        eng = MultiTenantEngine(EngineConfig(**_engine_cfg()), seed=5,
                                clock=clock, device="cpu")
        for name, arch in MIXED:
            assert eng.add_tenant(TenantSpec(name=name, slo_latency=60.0),
                                  get_reduced(arch, dtype="float32"))
        return clock, eng, lambda r: r.phase == Phase.DONE

    def ref_engine():
        clock = VirtualClock(0.25)
        eng = RefEngine(RefEngineConfig(**_engine_cfg()), seed=5,
                        clock=clock)
        for name, arch in MIXED:
            assert eng.add_tenant(TenantSpec(name=name, slo_latency=60.0),
                                  ref_reduced(arch, dtype="float32"))
        return clock, eng, lambda r: r.phase.value == "done"

    runs = {}
    for preempt in (False, True):
        got, mid = _mixed_run(port_engine, port_w, preempt)
        want, ref_mid = _mixed_run(ref_engine, ref_w, preempt)
        assert got == want
        assert all(len(g) == 8 and f is not None for _, g, _, f in got)
        runs[preempt] = got, mid, ref_mid
    (plain, _, _), (resumed, mid, ref_mid) = runs[False], runs[True]
    assert mid == ref_mid and 1 < len(mid) < 8
    assert resumed[0][1] == plain[0][1]     # resumed exactly
    assert resumed[0][3] > plain[0][3]      # it waited


def test_serve_launcher_default_tenants(capsys):
    """The launcher's default pair: tinyllama and olmoe (the
    reference's ``code:olmoe-1b-7b``)."""
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--requests", "4", "--policy", "none"])
    out = capsys.readouterr().out
    assert "admit code (olmoe-1b-7b): True" in out
    assert "completed=4 cloud=0" in out


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda_device():
    """The card, decided at run time; skips on CPU-only hosts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_moe_ffn_is_deterministic_and_matches_cpu(cuda_device):
    """olmoe's routing (64 experts, top-8) at a narrow width: on the card
    float32 agrees with the CPU within 1e-4 (bf16 would route the
    near-ties of 64 experts differently, see the bf16 logits test), two
    bf16 calls give the same bits (no atomics in the combine), and the
    dispatch of the same expert ids — past 4,096 tokens, with drops —
    equals the CPU's (the stable sort)."""
    cfg = get_reduced("olmoe-1b-7b", num_experts=64, experts_per_token=8,
                      d_model=256, dtype="float32")
    pm = PM.MoE(cfg, torch.Generator().manual_seed(1), "cpu")
    x = t(np.random.default_rng(3).standard_normal(
        (1, 1024, cfg.d_model)).astype(np.float32))
    want, want_aux = PM.moe_ffn(pm, x, cfg)
    pc = PM.MoE(cfg, torch.Generator().manual_seed(0), cuda_device)
    pc.load_state_dict(pm.state_dict())
    got, aux = PM.moe_ffn(pc, x.to(cuda_device), cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    pb = PM.MoE(bcfg, torch.Generator().manual_seed(0), cuda_device)
    pb.load_state_dict(pm.state_dict())
    xb = x.to(cuda_device, torch.bfloat16)
    assert torch.equal(PM.moe_ffn(pb, xb, bcfg)[0],
                       PM.moe_ffn(pb, xb, bcfg)[0])

    idx = torch.from_numpy(np.random.default_rng(4).integers(
        0, 64, (5000, 8)))
    C = PM.capacity(cfg, 5000)
    for got, ref in zip(PM.dispatch(idx.to(cuda_device), 64, C),
                        PM.dispatch(idx, 64, C)):
        assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "whisper-small",
                                  "llava-next-34b"))
def test_cuda_family_logits_match_cpu_f32(cuda_device, arch):
    """The reduced model on the card (K4 prefill, cross attention on K4,
    K5 decode over the self and the cross cache) against the same
    weights on the CPU, float32: logits within 1e-4 through a prefill
    and decode steps."""
    rcfg, _, rparams, pcfg, pm, pparams = models(arch, "float32")
    on_card = params_from_jax(pcfg, jax.tree.map(np.asarray, rparams),
                              device=cuda_device)
    cm = build_model(pcfg, device=cuda_device)
    batch = port_batch(prompt(pcfg, 2, 16))
    outs = []
    for model, params, dev in ((pm, pparams, "cpu"),
                               (cm, on_card, cuda_device)):
        logits, cache = model.prefill_fn(
            params, {k: v.to(dev) for k, v in batch.items()})
        cache = grow_cache(pcfg, cache, 24)
        got = [logits.cpu()]
        for step in range(4):
            token = torch.full((2,), 7 + step, device=dev)
            logits, cache = model.decode_fn(params, cache, token,
                                            torch.full((2,), 16 + step,
                                                       device=dev))
            got.append(logits.cpu())
        outs.append(got)
    for c, g in zip(*outs):
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-4)
