"""Mamba-2 and the hybrid (zamba2) stack in the port against the JAX
package, on the same inputs (CPU), and the K7 kernel against its plain
version (on a card only).

* K7's plain version against the reference's Pallas kernel in interpret
  mode and its oracle ``ssd_ref`` at the sweep shapes of
  tests/test_kernels.py, with its tolerances: 2e-5 in float32, 2e-2 in
  bfloat16, 1e-3 on the final state; plus an initial state against
  ``ssd_ref``.
* The model's functions on weights carried from the reference, float32,
  at 1e-5; ``ssd_chunked`` and ``mamba2_block`` at 2e-4, the reference's
  own tolerance for the chunked form, whose sums run in another order
  (tests/test_models.py).
* Reduced zamba2-2.7b: prefill logits plus 8 greedy decode steps at
  rtol/atol 1e-4 in float32 with equal token streams (a 16-token prompt,
  one SSD chunk, and a 256-token one, two), and max abs 5e-2 in
  bfloat16 on forced tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as RM
from repro.kernels import ops, ref
import repro_torch.models.mamba2 as PM
from repro_torch.kernels import fleet
from repro_torch.kernels import ssd as K7
from torch_lm_parity import models, run, t

ARCH = "zamba2-2.7b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


def _inputs(rng, B, H, T, P, N, dtype, bc_dtype="float32"):
    """x in ``dtype``, dt = softplus(normal), a_log = normal/2, B/C
    normals in ``bc_dtype``, as jax and torch pairs."""
    x = rng.standard_normal((B, H, T, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((B, H, T)))
    a_log = (rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, N)).astype(np.float32)
              for _ in range(2))
    (jx, tx), (jb, tb) = DTYPES[dtype], DTYPES[bc_dtype]
    jax_in = [jnp.asarray(x).astype(jx), jnp.asarray(dt), jnp.asarray(a_log),
              jnp.asarray(Bm).astype(jb), jnp.asarray(Cm).astype(jb)]
    torch_in = [t(x).to(tx), t(dt), t(a_log), t(Bm).to(tb), t(Cm).to(tb)]
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


# ---------------------------------------------------------------- K7
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,P,N,chunk", [
    (2, 2, 128, 16, 16, 32),
    (1, 4, 64, 32, 32, 64),
    (2, 1, 96, 16, 8, 32),
])
def test_ssd_plain_matches_pallas(B, H, T, P, N, chunk, dtype):
    jax_in, torch_in = _inputs(np.random.default_rng(T + P), B, H, T, P, N,
                               dtype)
    y, s = K7.ssd_forward(*torch_in, chunk=chunk)
    assert y.dtype == torch_in[0].dtype and y.shape == (B, H, T, P)
    assert s.dtype == torch.float32 and s.shape == (B, H, P, N)
    py, ps = ops.ssd_forward(*jax_in, chunk=chunk, interpret=True)
    ry, rs = ref.ssd_ref(*jax_in)
    for want_y, want_s in ((py, ps), (ry, rs)):
        np.testing.assert_allclose(_np(y), _np(want_y), **tol(dtype))
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_with_initial_state(dtype):
    rng = np.random.default_rng(5)
    jax_in, torch_in = _inputs(rng, 2, 2, 64, 16, 16, dtype)
    s0 = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    y, s = K7.ssd_forward(*torch_in, chunk=32, init_state=t(s0))
    ry, rs = ref.ssd_ref(*jax_in, init_state=jnp.asarray(s0))
    np.testing.assert_allclose(_np(y), _np(ry), **tol(dtype))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-3,
                               atol=1e-3)


def test_ssd_keeps_the_chunk_contract():
    """T must be a multiple of min(chunk, T), where the reference
    asserts it."""
    _, torch_in = _inputs(np.random.default_rng(0), 1, 1, 200, 8, 8,
                          "float32")
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        K7.ssd_forward(*torch_in)
    xh = torch_in[0].transpose(1, 2)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        PM.ssd_chunked(xh, torch_in[1].transpose(1, 2), *torch_in[2:])
    y, _ = K7.ssd_forward(*torch_in, chunk=40)
    assert y.shape == (1, 1, 200, 8)


def test_ssd_bound_counts_the_call():
    ms, by = K7.ssd_bound_ms(1, 80, 1024, 64, 64)
    assert by == "bytes"
    bytes_ = (2 * 80 * 1024 * 64 * 2 + 2 * 1024 * 64 * 2 + 4 * 80 * 1024
              + 4 * 80 + 4 * 80 * 64 * 64)
    assert ms == pytest.approx(1e3 * bytes_ / fleet.HBM_BYTES_PER_S)
    flops = 2 * 80 * 1024 * (128 * 64 * 2 + 2 * 64 * 64)
    assert flops / K7.BF16_FLOPS_PER_S * 1e3 < ms
    # f32: the recurrence's 5·P·N FLOPs per (step, head) at the f32 rate
    ms, by = K7.ssd_bound_ms(1, 80, 1024, 64, 64, itemsize=4, bc_itemsize=4)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 5 * 80 * 1024 * 64 * 64
                               / K7.F32_FLOPS_PER_S)


# ---------------------------------------------------------------- model
def _layer(seed=1):
    """The first Mamba-2 layer of a reduced f32 zamba2: the reference's
    tree and the port's module carrying the same weights."""
    rcfg, _, rparams, pcfg, _, pparams = models(ARCH, "float32", seed)
    lay = jax.tree.map(lambda a: a[0, 0], rparams["blocks"]["mamba"])
    return rcfg, lay["mamba"], pcfg, pparams.blocks.mamba[0][0].mamba


def test_causal_conv_matches_reference():
    rcfg, lay, pcfg, pm = _layer()
    rng = np.random.default_rng(2)
    C = pcfg.d_inner + 2 * pcfg.ssm_state
    xbc = rng.standard_normal((2, 9, C)).astype(np.float32)
    st = rng.standard_normal((2, pcfg.conv_width - 1, C)).astype(np.float32)
    for state in (None, st):
        r_out, r_st = RM._causal_conv(
            lay, jnp.asarray(xbc), rcfg,
            None if state is None else jnp.asarray(state))
        p_out, p_st = PM._causal_conv(pm, t(xbc), pcfg,
                                      None if state is None else t(state))
        np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out),
                                   rtol=1e-5, atol=1e-5)
        assert np.array_equal(p_st.numpy(), np.asarray(r_st))


def test_ssd_chunked_matches_reference_and_scan():
    """tests/test_models.py's chunked-vs-scan check on both packages."""
    rng = np.random.default_rng(8)
    Bz, seq, H, P, N = 2, 128, 4, 8, 16
    xh = rng.standard_normal((Bz, seq, H, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((Bz, seq, H)))
    a_log = (rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Bz, seq, N)).astype(np.float32)
              for _ in range(2))
    args = (xh, dt, a_log, Bm, Cm)
    y1, s1 = PM.ssd_chunked(*map(t, args), chunk=32)
    y2, s2 = PM.ssd_reference(*map(t, args))
    ry, rs = RM.ssd_chunked(*map(jnp.asarray, args), chunk=32)
    for y, s in ((y2, s2), (ry, rs)):
        np.testing.assert_allclose(y1.numpy(), _np(y), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(s1.numpy(), _np(s), rtol=2e-4, atol=2e-4)
    r2y, r2s = RM.ssd_reference(*map(jnp.asarray, args))
    np.testing.assert_allclose(y2.numpy(), np.asarray(r2y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(r2s), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block_matches_reference(with_state):
    rcfg, lay, pcfg, pm = _layer()
    rng = np.random.default_rng(9)
    B, S, D = 2, 32, pcfg.d_model
    C = pcfg.d_inner + 2 * pcfg.ssm_state
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((B, pcfg.conv_width - 1, C)
                                     ).astype(np.float32),
                 rng.standard_normal((B, pcfg.ssm_heads, pcfg.ssm_head_dim,
                                      pcfg.ssm_state)).astype(np.float32))
    r_out, (rc, rs) = RM.mamba2_block(
        lay, jnp.asarray(x), rcfg,
        None if state is None else tuple(map(jnp.asarray, state)))
    p_out, (pc, ps) = PM.mamba2_block(
        pm, t(x), pcfg, None if state is None else tuple(map(t, state)))
    for r, p in ((r_out, p_out), (rc, pc), (rs, ps)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-4)


def test_mamba2_step_matches_reference():
    rcfg, lay, pcfg, pm = _layer()
    rng = np.random.default_rng(10)
    B, D = 3, pcfg.d_model
    C = pcfg.d_inner + 2 * pcfg.ssm_state
    x = rng.standard_normal((B, D)).astype(np.float32)
    conv = rng.standard_normal((B, pcfg.conv_width - 1, C)).astype(np.float32)
    ssm = rng.standard_normal((B, pcfg.ssm_heads, pcfg.ssm_head_dim,
                               pcfg.ssm_state)).astype(np.float32)
    r_out, (rc, rs) = RM.mamba2_step(lay, jnp.asarray(x), rcfg,
                                     (jnp.asarray(conv), jnp.asarray(ssm)))
    p_out, (pc, ps) = PM.mamba2_step(pm, t(x), pcfg, (t(conv), t(ssm)))
    for r, p in ((r_out, p_out), (rc, pc), (rs, ps)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S", [16, 256])
def test_hybrid_logits_match_reference_f32(S):
    out = run(ARCH, "float32", S=S)
    for r, p in zip(out["ref"], out["port"]):
        np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-4)
    assert [x.tolist() for x in out["port_tok"]] == \
        [x.tolist() for x in out["ref_tok"]]


def test_hybrid_logits_match_reference_bf16():
    forced = np.random.default_rng(1).integers(0, 256, (8, 2))
    out = run(ARCH, "bfloat16", forced=forced)
    for r, p in zip(out["ref"], out["port"]):
        assert np.abs(p - r).max() <= 5e-2


def test_hybrid_weights_share_one_attention_block():
    *_, pcfg, _, pparams = models(ARCH, "bfloat16")
    blocks = pparams.blocks
    assert len(blocks.mamba) == pcfg.num_layers // pcfg.attn_every
    assert all(len(g) == pcfg.attn_every for g in blocks.mamba)
    assert blocks.shared.fuse.shape == (2 * pcfg.d_model, pcfg.d_model)
    m = blocks.mamba[0][0].mamba
    assert m.in_proj.dtype == torch.bfloat16
    assert m.a_log.dtype == m.dt_bias.dtype == torch.float32


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda_device():
    """The card, decided at run time; skips on CPU-only hosts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the card)")
    return torch.device("cuda")


def _model_layout(rng, B, T, H, P, N, dtype, device):
    """x, B and C as the model hands them to K7: column views of one
    (B, T, H·P + 2N) conv output, x seen as (B, H, T, P)."""
    xbc = torch.from_numpy(rng.standard_normal(
        (B, T, H * P + 2 * N)).astype(np.float32)).to(device, DTYPES[dtype][1])
    x = xbc[..., :H * P].reshape(B, T, H, P).transpose(1, 2)
    dt = torch.from_numpy(_softplus(rng.standard_normal((B, T, H)))).to(
        device).transpose(1, 2)
    a_log = torch.from_numpy((rng.standard_normal(H) * 0.5).astype(
        np.float32)).to(device)
    return [x, dt, a_log, xbc[..., H * P:H * P + N], xbc[..., H * P + N:]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(14)
    # the sweep shapes at the reference's tolerances; ragged last chunks
    # of the kernel's 64 steps (T = 1, 63, 65, 200, 1000); and the
    # model's strided layout at zamba2-2.7b's T = 1,024. In f32 a 200-step
    # run of 64-wide heads is held at 2e-4, the reference's tolerance for
    # the chunked form (tests/test_models.py): f32 sums over 64-step
    # chunks of such heads round past 2e-5; runs of 1,000 steps and more
    # at 1e-4 × max |y|, as chip_smoke.py holds the full-width runs
    for B, H, T, P, N, chunk, layout in [
            (2, 2, 128, 16, 16, 32, False), (1, 4, 64, 32, 32, 64, False),
            (2, 1, 96, 16, 8, 32, False), (1, 3, 200, 64, 64, 40, False),
            (2, 2, 1, 16, 16, 128, False), (2, 2, 63, 32, 16, 128, False),
            (2, 2, 65, 16, 32, 128, False), (2, 2, 1000, 64, 64, 200, False),
            (1, 80, 1024, 64, 64, 128, True),
            # rows of 12 elements: no 16-byte copies, padded tiles
            (2, 2, 70, 12, 12, 70, True)]:
        if layout:
            args = _model_layout(rng, B, T, H, P, N, dtype, cuda_device)
        else:
            _, torch_in = _inputs(rng, B, H, T, P, N, dtype)
            args = [x.to(cuda_device) for x in torch_in]
        s0 = torch.randn((B, H, P, N), device=cuda_device)
        for init in (None, s0):
            before = fleet.LAUNCHES["ssd"]
            y, s = K7.ssd_forward(*args, chunk=chunk, init_state=init)
            assert fleet.LAUNCHES["ssd"] == before + 1
            # the plain version in f64 is the oracle: two f32 sums in
            # different orders can differ by more than the tolerance
            want_y, want_s = K7.ssd_forward_plain(
                *(a.double() for a in args), chunk=chunk,
                init_state=None if init is None else init.double())
            if dtype == "bfloat16" or T < 200:
                case_tol = tol(dtype)
            elif T == 200:
                case_tol = dict(rtol=2e-4, atol=2e-4)
            else:
                case_tol = dict(rtol=0.0,
                                atol=1e-4 * float(want_y.abs().max()))
            torch.testing.assert_close(y.double(), want_y, **case_tol)
            torch.testing.assert_close(s.double(), want_s, rtol=1e-3,
                                       atol=1e-3)
