"""RWKV-6 in the port against the JAX package, on the same inputs (CPU),
and the K6 kernel against its plain version (on a card only).

* K6's plain version against the reference's Pallas kernel in interpret
  mode and its oracle ``rwkv6_ref`` at the sweep shapes of
  tests/test_kernels.py, with its tolerances: 2e-5 in float32
  (summation order), 2e-2 in bfloat16 (one output rounding), 1e-3 on
  the final state; plus an initial state against ``rwkv6_ref``.
* The model's functions on weights carried from the reference, float32,
  at 1e-5 (summation order and transcendental implementations only).
* Reduced rwkv6-3b: prefill logits plus 8 greedy decode steps at
  rtol/atol 1e-4 in float32 with equal token streams, and max abs 5e-2
  in bfloat16 on forced tokens (both round activations at every matmul).

Inputs are float32 from a seeded numpy generator, rounded to bfloat16
the same way on both sides where a case asks for it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rwkv6 as RR
from repro.kernels import ops, ref
from repro.models.layers import group_norm_heads as ref_group_norm
from repro.models.transformer import rwkv_stack as ref_rwkv_stack
import repro_torch.models.rwkv6 as PR
from repro_torch.kernels import fleet
from repro_torch.kernels import rwkv6 as K6
from repro_torch.models.layers import group_norm_heads
from repro_torch.models.transformer import rwkv_stack
from torch_lm_parity import models, run, t

ARCH = "rwkv6-3b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(rng, B, H, T, K, dtype):
    """r/k/v normals in ``dtype``, w = sigmoid(normal) f32, u normal f32,
    as jax and torch pairs."""
    jd, td = DTYPES[dtype]
    rkv = [rng.standard_normal((B, H, T, K)).astype(np.float32)
           for _ in range(3)]
    w = (1 / (1 + np.exp(-rng.standard_normal((B, H, T, K))))
         ).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    jax_in = [jnp.asarray(x).astype(jd) for x in rkv] + \
        [jnp.asarray(w), jnp.asarray(u)]
    torch_in = [t(x).to(td) for x in rkv] + [t(w), t(u)]
    return jax_in, torch_in


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- K6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,K,chunk", [
    (2, 2, 64, 16, 16),
    (1, 4, 96, 32, 32),
    (2, 1, 50, 16, 16),    # T not a multiple of the Pallas chunk
])
def test_rwkv6_plain_matches_pallas(B, H, T, K, chunk, dtype):
    jax_in, torch_in = _inputs(np.random.default_rng(T + H), B, H, T, K,
                               dtype)
    o, s = K6.rwkv6_forward(*torch_in)
    assert o.dtype == torch_in[0].dtype and o.shape == (B, H, T, K)
    assert s.dtype == torch.float32 and s.shape == (B, H, K, K)
    po, ps = ops.rwkv6_forward(*jax_in, chunk=chunk, interpret=True)
    ro, rs = ref.rwkv6_ref(*jax_in)
    for want_o, want_s in ((po, ps), (ro, rs)):
        np.testing.assert_allclose(_np(o), _np(want_o), **tol(dtype))
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_plain_with_initial_state(dtype):
    rng = np.random.default_rng(5)
    jax_in, torch_in = _inputs(rng, 2, 2, 40, 16, dtype)
    s0 = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    o, s = K6.rwkv6_forward(*torch_in, init_state=t(s0))
    ro, rs = ref.rwkv6_ref(*jax_in, init_state=jnp.asarray(s0))
    np.testing.assert_allclose(_np(o), _np(ro), **tol(dtype))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-3,
                               atol=1e-3)


def test_rwkv6_wrapper_refuses_bad_shapes():
    r = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError):
        K6.rwkv6_forward(r, r, r, r, torch.zeros((2, 8)))
    with pytest.raises(ValueError):
        K6.rwkv6_forward(r, r, r, r, torch.zeros((2, 16)),
                         init_state=torch.zeros((1, 2, 16, 8)))


@pytest.mark.parametrize("K,itemsize,by,form", [
    (64, 2, "bytes", None),               # rwkv6-3b's prefill, bf16
    (128, 4, "operations", "recurrence"),  # f32: 5·K² < 4·L·K + 4·K²
    (512, 4, "operations", "chunked"),     # f32 with K > 4·L
])
def test_rwkv6_bound_counts_the_call(K, itemsize, by, form):
    """The larger of the bytes and the operations of the quicker of the
    function's two forms: the recurrence (5·K² f32 FLOPs a step-head at
    the f32 rate) and the chunked form (4·L·K + 4·K² at chunk L = 64, at
    the bf16 tensor-core rate for bf16 inputs, the f32 rate for f32)."""
    ms, got_by = K6.rwkv6_bound_ms(1, 40, 1024, K, itemsize=itemsize)
    assert got_by == by
    steps = 40 * 1024
    bytes_ = (steps * K * (4 * itemsize + 4) + 4 * 40 * K
              + 4 * 40 * K * K)
    t_bytes = 1e3 * bytes_ / fleet.HBM_BYTES_PER_S
    rate = K6.BF16_FLOPS_PER_S if itemsize == 2 else K6.F32_FLOPS_PER_S
    t_rec = 1e3 * 5 * K * K * steps / K6.F32_FLOPS_PER_S
    t_chunk = 1e3 * (4 * 64 * K + 4 * K * K) * steps / rate
    assert ms == pytest.approx(max(t_bytes, min(t_rec, t_chunk)))
    if form == "recurrence":
        assert t_rec < t_chunk and ms == pytest.approx(t_rec)
    elif form == "chunked":
        assert t_chunk < t_rec and ms == pytest.approx(t_chunk)
    else:       # bf16 at rwkv6-3b's shape: 9.4 µs of bytes, not 12.5 µs
        assert ms == pytest.approx(t_bytes) and t_chunk < t_bytes < t_rec


# ---------------------------------------------------------------- model
def _layer(arch=ARCH, seed=1):
    """Layer 0 of a reduced f32 model: the reference's tree and the
    port's block carrying the same weights."""
    rcfg, _, rparams, pcfg, _, pparams = models(arch, "float32", seed)
    lay = jax.tree.map(lambda a: a[0], rparams["layers"])
    return rcfg, lay, pcfg, pparams.layers[0]


def test_group_norm_heads_matches_reference():
    rng = np.random.default_rng(2)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32)
                      for s in ((3, 5, 4, 16), (4, 16), (4, 16)))
    want = ref_group_norm(*map(jnp.asarray, (x, scale, bias)))
    got = group_norm_heads(t(x), t(scale), t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(with_state):
    rcfg, lay, pcfg, blk = _layer()
    rng = np.random.default_rng(3)
    B, S, D = 2, 24, pcfg.d_model
    H, K = pcfg.rwkv_heads, pcfg.rwkv_head_size
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((B, D)).astype(np.float32),
                 rng.standard_normal((B, H, K, K)).astype(np.float32))
    r_out, (rx, rs) = RR.time_mix(
        lay["att"], jnp.asarray(x), rcfg,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    p_out, (px, ps) = PR.time_mix(
        blk.att, t(x), pcfg,
        state=None if state is None else tuple(map(t, state)))
    for r, p in ((r_out, p_out), (rx, px), (rs, ps)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_time_mix_step_matches_reference():
    rcfg, lay, pcfg, blk = _layer()
    rng = np.random.default_rng(4)
    B, D = 3, pcfg.d_model
    H, K = pcfg.rwkv_heads, pcfg.rwkv_head_size
    x, xp = (rng.standard_normal((B, D)).astype(np.float32)
             for _ in range(2))
    s = rng.standard_normal((B, H, K, K)).astype(np.float32)
    r_out, (rx, rs) = RR.time_mix_step(lay["att"], jnp.asarray(x), rcfg,
                                       (jnp.asarray(xp), jnp.asarray(s)))
    p_out, (px, ps) = PR.time_mix_step(blk.att, t(x), pcfg, (t(xp), t(s)))
    for r, p in ((r_out, p_out), (rx, px), (rs, ps)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_channel_mix_matches_reference():
    rcfg, lay, pcfg, blk = _layer()
    rng = np.random.default_rng(6)
    B, S, D = 2, 12, pcfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    xp = rng.standard_normal((B, D)).astype(np.float32)
    for state in (None, xp):
        r_out, rx = RR.channel_mix(
            lay["ffn"], jnp.asarray(x), rcfg,
            state=None if state is None else jnp.asarray(state))
        p_out, px = PR.channel_mix(blk.ffn, t(x), pcfg,
                                   state=None if state is None else t(state))
        np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out),
                                   rtol=1e-5, atol=1e-5)
        assert np.array_equal(px.numpy(), np.asarray(rx))
    r_out, _ = RR.channel_mix_step(lay["ffn"], jnp.asarray(x[:, 0]), rcfg,
                                   jnp.asarray(xp))
    p_out, _ = PR.channel_mix_step(blk.ffn, t(x[:, 0]), pcfg, t(xp))
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), rtol=1e-5,
                               atol=1e-5)


def test_rwkv_stack_with_state_matches_reference():
    """A prompt continued from carried per-layer states (the reference's
    ``rwkv_stack(state=...)``), float32."""
    rcfg, _, rparams, pcfg, _, pparams = models(ARCH, "float32", seed=2)
    rng = np.random.default_rng(7)
    L, B, S, D = pcfg.num_layers, 2, 10, pcfg.d_model
    H, K = pcfg.rwkv_heads, pcfg.rwkv_head_size
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    state = {"att_x": rng.standard_normal((L, B, D)).astype(np.float32),
             "att_s": rng.standard_normal((L, B, H, K, K)).astype(np.float32),
             "ffn_x": rng.standard_normal((L, B, D)).astype(np.float32)}
    rx, rst = ref_rwkv_stack(rparams["layers"], jnp.asarray(x), rcfg,
                             state={k: jnp.asarray(v) for k, v in state.items()},
                             collect_state=True)
    px, pst = rwkv_stack(pparams.layers, t(x), pcfg,
                         state={k: t(v) for k, v in state.items()},
                         collect_state=True)
    np.testing.assert_allclose(px.numpy(), np.asarray(rx), rtol=1e-4,
                               atol=1e-4)
    for k in state:
        np.testing.assert_allclose(pst[k].numpy(), np.asarray(rst[k]),
                                   rtol=1e-4, atol=1e-4)


def test_rwkv_logits_match_reference_f32():
    out = run(ARCH, "float32")
    for r, p in zip(out["ref"], out["port"]):
        np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-4)
    assert [x.tolist() for x in out["port_tok"]] == \
        [x.tolist() for x in out["ref_tok"]]


def test_rwkv_logits_match_reference_bf16():
    forced = np.random.default_rng(1).integers(0, 256, (8, 2))
    out = run(ARCH, "bfloat16", forced=forced)
    for r, p in zip(out["ref"], out["port"]):
        assert np.abs(p - r).max() <= 5e-2


def test_rwkv_weights_in_the_reference_use_dtypes():
    *_, pparams = models(ARCH, "bfloat16")
    att = pparams.layers[0].att
    assert att.wr.dtype == torch.bfloat16 and att.mu.dtype == torch.bfloat16
    assert att.w_dec1.dtype == att.u.dtype == torch.float32
    assert att.ln_x_scale.dtype == torch.float32


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda_device():
    """The card, decided at run time; skips on CPU-only hosts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(13)
    # the sweep shapes; ragged last chunks of the kernel's 64 steps (T =
    # 1, 63, 65, 1000); strong decays (w = sigmoid(-8)) and decays near
    # 1; and the model's (B, T, H, K) projections seen as (B, H, T, K) at
    # rwkv6-3b's T = 1,024. Runs of 1,000 steps and more in f32 are held
    # at 1e-4 × max |o|, as chip_smoke.py holds the full-width runs, and
    # so are decays near 1 in f32: the state grows to where f32 sums of
    # r·S round past 2e-5 in any order (the plain version run in f32
    # misses 2e-5 against f64 there by 2.4×)
    for B, H, T, K, decay, layout in [
            (2, 2, 64, 16, None, False), (1, 4, 96, 32, None, False),
            (2, 1, 50, 64, None, False), (2, 2, 1, 32, None, False),
            (2, 2, 63, 64, None, False), (2, 2, 65, 16, None, False),
            (2, 2, 1000, 64, None, False), (2, 2, 130, 64, -8.0, False),
            (2, 2, 130, 64, 8.0, False), (1, 40, 1024, 64, None, True)]:
        _, torch_in = _inputs(rng, B, H, T, K, dtype)
        if decay is not None:
            torch_in[3] = torch.sigmoid(decay + 0.1 * torch_in[3])
        if layout:
            torch_in = [x.transpose(1, 2).contiguous().transpose(1, 2)
                        for x in torch_in[:4]] + torch_in[4:]
        args = [x.to(cuda_device) for x in torch_in]
        if layout:
            assert args[0].stride(2) == H * K
        s0 = torch.randn((B, H, K, K), device=cuda_device)
        for init in (None, s0):
            before = fleet.LAUNCHES["rwkv6"]
            o, s = K6.rwkv6_forward(*args, init_state=init)
            assert fleet.LAUNCHES["rwkv6"] == before + 1
            # the plain version in f64 is the oracle: two f32 sums in
            # different orders can differ by more than the tolerance
            want_o, want_s = K6.rwkv6_forward_plain(
                *(a.double() for a in args),
                None if init is None else init.double())
            case_tol = (dict(rtol=0.0, atol=1e-4 * float(want_o.abs().max()))
                        if dtype == "float32" and (T >= 1000 or decay == 8.0)
                        else tol(dtype))
            torch.testing.assert_close(o.double(), want_o, **case_tol)
            torch.testing.assert_close(s.double(), want_s, rtol=1e-3,
                                       atol=1e-3)
