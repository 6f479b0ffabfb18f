"""The port's dense decoder against the JAX package's on the same
weights (CPU, reduced tinyllama-1.1b).

Weights come from the reference's ``init_params`` and pass through
numpy into the port (``params_from_jax``); inputs are made with numpy
from a seed. Tolerances: in float32 the two frameworks differ only in
summation order and transcendental implementations, so logits agree at
rtol/atol 1e-4 and the greedy token streams are equal; in bfloat16 both
round activations at every matmul, so the port is held to max abs 5e-2
on the same (teacher-forced) tokens. The attention functions are held
to the reference at 1e-5 in float32 (its own test tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
from repro.configs import get_reduced as ref_reduced
from repro.models.kvcache import write_slot as ref_write_slot
from repro.serving.engine import _insert_cache as ref_insert_cache
import repro_torch.models.attention as PA
from repro_torch.configs import get_reduced
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.kvcache import write_slot
from repro_torch.serving.engine import _insert_cache
from torch_lm_parity import models, run, t

ARCH = "tinyllama-1.1b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", [ARCH, "starcoder2-3b", "h2o-danube-3-4b",
                                  "granite-8b"])
def test_decoder_logits_match_reference_f32(arch):
    """tinyllama and granite (RMSNorm, SiLU), starcoder2 (LayerNorm, tanh
    GELU), h2o-danube (sliding window, ring-buffer cache)."""
    out = run(arch, "float32")
    for r, p in zip(out["ref"], out["port"]):
        np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-4)
    assert [t.tolist() for t in out["port_tok"]] == \
        [t.tolist() for t in out["ref_tok"]]


def test_decoder_logits_match_reference_bf16():
    forced = np.random.default_rng(1).integers(0, 256, (8, 2))
    out = run(ARCH, "bfloat16", forced=forced)
    for r, p in zip(out["ref"], out["port"]):
        assert np.abs(p - r).max() <= 5e-2


def test_params_from_jax_holds_matrices_in_compute_dtype():
    *_, pcfg, pm, pparams = models(ARCH, "bfloat16")
    blk = pparams.layers[0]
    assert blk.attn.wq.dtype == torch.bfloat16
    assert blk.ln1.scale.dtype == torch.float32
    assert len(pparams.layers) == pcfg.num_layers
    assert pparams.tok.embed.shape == (pcfg.padded_vocab, pcfg.d_model)


def test_other_families_raise_with_their_slice():
    for arch in ("olmoe-1b-7b", "whisper-small", "llava-next-34b"):
        with pytest.raises(NotImplementedError, match="slice 3"):
            build_model(get_reduced(arch), device="cpu")


# ------------------------------------------------------------- attention
def _qkv(rng, b, s, h, kh, d=16):
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32))


@pytest.mark.parametrize("h,kh,seq,chunk", [(4, 2, 96, 32), (8, 8, 64, 64),
                                            (4, 1, 128, 32)])
def test_chunked_attention_matches_reference(h, kh, seq, chunk):
    q, k, v = _qkv(np.random.default_rng(seq + h), 2, seq, h, kh)
    ref = RA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, chunk=chunk)
    got = PA.chunked_attention(t(q), t(k), t(v), causal=True, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    full = PA.full_attention_reference(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seq,w", [(128, 32), (64, 64), (96, 32)])
def test_swa_attention_matches_reference(seq, w):
    q, k, v = _qkv(np.random.default_rng(seq + w), 2, seq, 4, 2)
    ref = RA.swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           window=w)
    got = PA.swa_attention(t(q), t(k), t(v), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    full = RA.full_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True, window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(full), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 8])
def test_attention_block_matches_reference(window):
    """``attention()`` (projections, RoPE, the CPU attention path and the
    output projection) on carried weights, float32."""
    kw = dict(dtype="float32")
    if window:
        kw.update(attention="swa", window=window)
    rcfg, pcfg = ref_reduced(ARCH, **kw), get_reduced(ARCH, **kw)
    rp = RA.attn_params(jax.random.key(5), rcfg)
    pm = params_from_jax(pcfg, {
        "tok": {"embed": np.zeros((pcfg.padded_vocab, pcfg.d_model)),
                "unembed": np.zeros((pcfg.d_model, pcfg.padded_vocab))},
        "ln_f": {"scale": np.zeros(pcfg.d_model)},
        "layers": {
            "ln1": {"scale": np.zeros((2, pcfg.d_model))},
            "ln2": {"scale": np.zeros((2, pcfg.d_model))},
            "attn": {n: np.stack([np.asarray(a)] * 2) for n, a in rp.items()},
            "mlp": {"w_gate": np.zeros((2, pcfg.d_model, pcfg.d_ff)),
                    "w_up": np.zeros((2, pcfg.d_model, pcfg.d_ff)),
                    "w_down": np.zeros((2, pcfg.d_ff, pcfg.d_model))}}},
        device="cpu")
    x = np.random.default_rng(3).standard_normal(
        (2, 24, pcfg.d_model)).astype(np.float32)
    pos = np.arange(24)[None, :]
    r_out, (rk, rv) = RA.attention(rp, jnp.asarray(x), rcfg, jnp.asarray(pos))
    p_out, (pk, pv) = PA.attention(pm.layers[0].attn, t(x), pcfg, t(pos))
    for r, p in ((r_out, p_out), (rk, pk), (rv, pv)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------------- cache layouts
def test_write_slot_matches_reference():
    rng = np.random.default_rng(7)
    kc, vc = (rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((3, 1, 2, 16)).astype(np.float32)
              for _ in range(2))
    slot = np.array([4, 0, 9], np.int32)
    rk, rv = ref_write_slot((jnp.asarray(kc), jnp.asarray(vc)),
                            jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(slot))
    pk, pv = write_slot((t(kc.copy()), t(vc.copy())), t(kn), t(vn),
                        t(slot).long())
    assert np.array_equal(pk.numpy(), np.asarray(rk))
    assert np.array_equal(pv.numpy(), np.asarray(rv))


def test_insert_cache_matches_reference():
    """The engine's dense insert: the prefill's S positions at the slot,
    cast to the cache dtype (bf16), zeros past them."""
    cfg_r, cfg_p = ref_reduced(ARCH), get_reduced(ARCH)
    rng = np.random.default_rng(8)
    shape = (2, 4, 12, 2, 16)
    full = {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}
    one = {k: rng.standard_normal((2, 1, 5, 2, 16)).astype(np.float32)
           for k in ("k", "v")}
    ref = ref_insert_cache(
        {k: jnp.asarray(a, jnp.bfloat16) for k, a in full.items()},
        {k: jnp.asarray(a) for k, a in one.items()}, 2, cfg_r, 12)
    got = _insert_cache({k: t(a).to(torch.bfloat16)
                         for k, a in full.items()},
                        {k: t(a) for k, a in one.items()}, 2, cfg_p, 12)
    for k in ("k", "v"):
        assert np.array_equal(got[k].float().numpy(),
                              np.asarray(ref[k], np.float32))
        assert not got[k][:, 2, 5:].any()


def test_dense_cache_helpers_match_reference():
    from repro.models import kvcache as RK
    from repro_torch.models import kvcache as PK

    for arch in (ARCH, "h2o-danube-3-4b"):
        rc, pc = ref_reduced(arch), get_reduced(arch)
        assert PK.dense_cache_shape(pc, 3, 100) == \
            RK.dense_cache_shape(rc, 3, 100)
        cache = PK.init_dense_cache(pc, 3, 100, device="cpu")
        assert cache["k"].shape == RK.dense_cache_shape(rc, 3, 100)
        assert cache["k"].dtype == torch.bfloat16 and not cache["v"].any()


def test_paged_pool_and_gather_match_reference():
    from repro.models import kvcache as RK
    from repro_torch.models import kvcache as PK

    rcfg = RK.PagedPoolConfig(num_pages=8, page_size=4, num_kv_heads=2,
                              head_dim=16, num_layers=2)
    pcfg = PK.PagedPoolConfig(num_pages=8, page_size=4, num_kv_heads=2,
                              head_dim=16, num_layers=2)
    assert pcfg.bytes_per_page == rcfg.bytes_per_page
    rp, pp = RK.PagedKVPool(rcfg), PK.PagedKVPool(pcfg, device="cpu")
    for pool in (rp, pp):
        a = pool.alloc("a", 3)
        pool.alloc("b", 2)
        pool.free(a[:1])
    assert (pp.free_pages, pp.pages_owned("a"), pp.pages_owned("b")) == \
        (rp.free_pages, rp.pages_owned("a"), rp.pages_owned("b"))
    assert pp.release_tenant("b") == rp.release_tenant("b") == 2
    with pytest.raises(MemoryError):
        pp.alloc("c", 9)
    rng = np.random.default_rng(9)
    kp, vp = (rng.standard_normal((2, 8, 4, 2, 16)).astype(np.float32)
              for _ in range(2))
    table = np.array([[3, 1], [0, 7]], np.int32)
    rk, rv = RK.gather_pages(jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(table))
    gk, gv = PK.gather_pages(t(kp), t(vp), t(table))
    assert np.array_equal(gk.numpy(), np.asarray(rk))
    assert np.array_equal(gv.numpy(), np.asarray(rv))
    tok = rng.standard_normal((2, 16)).astype(np.float32)
    pp.write(1, 5, 2, t(tok), t(tok))
    rp.write(1, 5, 2, jnp.asarray(tok), jnp.asarray(tok))
    assert np.array_equal(pp.k.float().numpy(), np.asarray(rp.k, np.float32))


def test_cross_entropy_matches_reference():
    from repro.models.layers import cross_entropy as ref_ce
    from repro_torch.models.layers import cross_entropy

    rng = np.random.default_rng(10)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int64)
    mask = (rng.random((3, 5)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = ref_ce(jnp.asarray(logits), jnp.asarray(labels),
                      None if m is None else jnp.asarray(m))
        got = cross_entropy(t(logits), t(labels),
                            None if m is None else t(m))
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(w) for w in want], rtol=1e-6)
