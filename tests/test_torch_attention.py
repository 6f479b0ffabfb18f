"""The attention kernels' plain versions (K4 flash, K5 paged) against the
JAX package's Pallas kernels in interpret mode and its oracles, on the
same inputs (CPU), and the CUDA kernels against their plain versions
(on a card only).

Tolerances are the reference's own (tests/test_kernels.py): 2e-5 in
float32 (summation order), 2e-2 in bfloat16 (one output rounding);
1e-6 for the quota-resize invariant; 2e-5 for decode attention through
the identity page table against the reference's ``decode_attention``.
Inputs are float32 normals from a seeded numpy generator, rounded to
bfloat16 the same way on both sides where a case asks for it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
from repro.kernels import ops, ref
from repro_torch.kernels import attention as K
from repro_torch.kernels import fleet
import repro_torch.models.attention as PA

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------- K4 flash
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,S,D,bq,bk", [
    (2, 4, 2, 128, 32, 64, 64),
    (1, 8, 8, 64, 64, 32, 32),     # MHA
    (2, 4, 1, 96, 16, 32, 32),     # MQA, ragged seq vs block
    (1, 2, 2, 130, 32, 64, 64),    # non-multiple seq (padding path)
])
def test_flash_plain_matches_pallas(B, H, KH, S, D, bq, bk, dtype):
    rng = np.random.default_rng(S + H)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, dtype) for s in (
        (B, H, S, D), (B, KH, S, D), (B, KH, S, D)))
    got = K.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = ops.flash_attention(qj, kj, vj, causal=True, block_q=bq,
                                 block_k=bk, interpret=True)
    oracle = ref.flash_attention_ref(qj, kj, vj, causal=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **tol(dtype))


@pytest.mark.parametrize("window", [32, 64])
def test_flash_plain_sliding_window(window):
    rng = np.random.default_rng(window)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, "float32") for s in (
        (2, 4, 128, 32), (2, 2, 128, 32), (2, 2, 128, 32)))
    got = K.flash_attention(qt, kt, vt, causal=True, window=window)
    pallas = ops.flash_attention(qj, kj, vj, causal=True, window=window,
                                 block_q=32, block_k=32, interpret=True)
    oracle = ref.flash_attention_ref(qj, kj, vj, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=2e-5, atol=2e-5)


def test_flash_plain_noncausal():
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (1, 2, 64, 32), "float32")
                                    for _ in range(3))
    got = K.flash_attention(qt, kt, vt, causal=False)
    pallas = ops.flash_attention(qj, kj, vj, causal=False, block_q=32,
                                 block_k=32, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _np(got), _np(ref.flash_attention_ref(qj, kj, vj, causal=False)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seq,heads,seed", [(32, (4, 2), 0), (64, (4, 4), 1),
                                            (96, (8, 1), 2)])
def test_flash_plain_property(seq, heads, seed):
    """kernel == oracle for GQA configs; rows are convex combinations of
    V rows, so |out| <= max |v|."""
    H, KH = heads
    rng = np.random.default_rng(seed)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, "float32") for s in (
        (1, H, seq, 16), (1, KH, seq, 16), (1, KH, seq, 16)))
    got = K.flash_attention(qt, kt, vt, causal=True)
    np.testing.assert_allclose(
        _np(got), _np(ref.flash_attention_ref(qj, kj, vj, causal=True)),
        rtol=3e-5, atol=3e-5)
    assert float(got.abs().max()) <= float(vt.abs().max()) + 1e-4


def test_flash_plain_takes_strided_views():
    """The model passes (B, S, H, D) activations as (B, H, S, D) views."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, 2, 16)).astype(
        np.float32)) for _ in range(2))
    got = K.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True).transpose(1, 2)
    want = PA.full_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------- K5 paged
def _paged_inputs(rng, B, H, KH, D, page, pool, mp, dtype):
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, dtype) for s in (
        (B, H, D), (KH, pool, page, D), (KH, pool, page, D)))
    pt = np.stack([rng.choice(pool, size=mp, replace=False)
                   for _ in range(B)]).astype(np.int32)
    ln = rng.integers(1, mp * page + 1, size=B).astype(np.int32)
    return (qj, kj, vj, jnp.asarray(pt), jnp.asarray(ln)), \
        (qt, kt, vt, torch.from_numpy(pt), torch.from_numpy(ln))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,D,page,pool,mp", [
    (2, 4, 2, 32, 16, 32, 4),
    (3, 8, 8, 64, 8, 64, 6),
    (1, 4, 1, 16, 16, 16, 2),
])
def test_paged_plain_matches_pallas(B, H, KH, D, page, pool, mp, dtype):
    jax_in, torch_in = _paged_inputs(np.random.default_rng(B * H + D), B, H,
                                     KH, D, page, pool, mp, dtype)
    got = K.paged_attention(*torch_in)
    assert got.dtype == torch_in[0].dtype and got.shape == (B, H, D)
    pallas = ops.paged_attention(*jax_in, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol(dtype))
    np.testing.assert_allclose(_np(got), _np(ref.paged_attention_ref(
        *jax_in)), **tol(dtype))


def test_paged_quota_resize_is_data_stable():
    """DYVERSE invariant: growing a tenant's page quota (appending table
    entries) must not change attention over the existing prefix."""
    rng = np.random.default_rng(5)
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((1, 4, 32), (2, 32, 16, 32), (2, 32, 16, 32)))
    small = torch.tensor([[3, 7]], dtype=torch.int32)
    big = torch.tensor([[3, 7, 11, 19]], dtype=torch.int32)
    ln = torch.tensor([29], dtype=torch.int32)
    torch.testing.assert_close(K.paged_attention(q, kp, vp, small, ln),
                               K.paged_attention(q, kp, vp, big, ln),
                               rtol=1e-6, atol=1e-6)


def test_dense_cache_pages_is_a_view_with_identity_table():
    cache = torch.arange(2 * 24 * 3 * 4, dtype=torch.float32).reshape(
        2, 24, 3, 4)
    pool, page = K.dense_cache_pages(cache)
    assert page == 8 and pool.shape == (3, 6, 8, 4)
    assert pool.data_ptr() == cache.data_ptr()
    table = K.identity_page_table(2, 24, page, "cpu")
    assert table.tolist() == [[0, 1, 2], [3, 4, 5]]
    # slot 1, token 13, kv head 2 lives at page 3 + 13 // 8, row 13 % 8
    assert torch.equal(pool[2, table[1, 13 // 8], 13 % 8], cache[1, 13, 2])


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("smax", [32, 40])
def test_decode_attention_matches_reference(window, smax):
    """The port's decode path (K5 over the identity page table of the
    dense cache) against the reference's ``decode_attention``, f32."""
    rng = np.random.default_rng(smax + window)
    B, H, KH, D = 3, 8, 2, 16
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, smax, KH, D)).astype(np.float32)
              for _ in range(2))
    cache_len = np.array([1, smax // 2 + 3, smax], np.int32)
    want = RA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(cache_len),
                               window=window)
    got = PA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc),
                              torch.from_numpy(cache_len), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_bounds_count_what_the_data_needs():
    ms, by = K.flash_attention_bound_ms(1, 32, 4, 1024, 1024, 64)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 4 * 64 * 32 * 1024 * 1025 / 2
                               / K.BF16_FLOPS_PER_S)
    assert K.visible_pairs(8, 8, True, 3) == 1 + 2 + 3 * 6
    ms, by = K.paged_attention_bound_ms([1056] * 8, 4, 32, 64, 128, 16)
    assert by == "bytes" and 2.5e-3 < ms < 2.7e-3


def test_wrappers_refuse_mixed_devices_and_bad_shapes():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError):
        K.flash_attention(q, k, torch.zeros((1, 2, 9, 16)))
    with pytest.raises(ValueError):
        K.flash_attention(q, k, k.to("meta"))


# ------------------------------------------------- K5 split over the sequence
def _split_partials(q, k_pool, v_pool, table, lengths, splits):
    """Each split's partial softmax state by plain f32 arithmetic over the
    token ranges K5's CTAs take: m, l (B, H, S) and acc (B, H, S, D)."""
    B, H, D = q.shape
    KH, _, page, _ = k_pool.shape
    G, cap = H // KH, table.shape[1] * page
    m = torch.full((B, H, splits), K.NEG_INF)
    l = torch.zeros((B, H, splits))
    acc = torch.zeros((B, H, splits, D))
    qs = q.float().reshape(B, KH, G, D) * D ** -0.5
    for b in range(B):
        for s, (t0, t1) in enumerate(K.paged_split_bounds(
                int(lengths[b]), cap, splits)):
            if t0 == t1:
                continue
            tok = torch.arange(t0, t1)
            pages = table[b, tok // page].long()
            kb = k_pool[:, pages, tok % page].float()      # (KH, n, D)
            vb = v_pool[:, pages, tok % page].float()
            sc = torch.einsum("hgd,hnd->hgn", qs[b], kb)
            mb = sc.amax(dim=-1)
            pb = torch.exp(sc - mb[..., None])
            m[b, :, s] = mb.reshape(H)
            l[b, :, s] = pb.sum(dim=-1).reshape(H)
            acc[b, :, s] = torch.einsum("hgn,hnd->hgd", pb, vb).reshape(H, D)
    return m, l, acc


def test_paged_split_plan():
    # tinyllama's decode: 8 sequences × 4 kv heads of 8 rows on 132 SMs
    assert K.paged_rows(8) == 8 and K.paged_rows(1) == 1
    assert [K.paged_rows(g) for g in (2, 3, 4, 5, 7, 12)] == [2, 4, 4, 8, 8,
                                                             8]
    assert K.paged_splits(32, 2048) == 5            # 160 CTAs, not 32
    assert K.paged_splits(256, 2048) == 1           # zamba2: G = 1, KH 32
    assert K.paged_splits(132, 2048) == 1           # the grid fills the card
    assert K.paged_splits(1, 100) == 1              # one round of capacity
    assert K.paged_splits(1, 129) == 2
    assert K.paged_splits(1, 2048) == 16            # capped by 16 rounds
    assert K.paged_splits(1, 65536) == K.PAGED_MAX_SPLITS
    assert K.paged_splits(16, 2048, sms=114) == 8


@pytest.mark.parametrize("length,cap,splits", [
    (1056, 2048, 9), (1025, 2048, 9), (1, 2048, 9), (0, 512, 4),
    (512, 512, 4), (511, 512, 4), (300, 512, 4), (5000, 2048, 3),
    (129, 256, 2)])
def test_paged_split_bounds_cover_the_length(length, cap, splits):
    bounds = K.paged_split_bounds(length, cap, splits)
    n = min(length, cap)
    assert len(bounds) == splits
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    size = bounds[0][1] - bounds[0][0] if n else K.PAGED_ROUND
    assert size % K.PAGED_ROUND == 0 or size == n
    for (a0, a1), (b0, b1) in zip(bounds, bounds[1:]):
        assert a1 == b0 and a0 <= a1 <= cap
    # whole rounds: every non-empty split but the last is full
    full = [t1 - t0 for t0, t1 in bounds if t1 > t0][:-1]
    assert all(x == full[0] and x % K.PAGED_ROUND == 0 for x in full)


@pytest.mark.parametrize("splits", [1, 3, 4])
@pytest.mark.parametrize("H,KH,D", [(8, 2, 32), (4, 4, 16), (16, 2, 64)])
def test_paged_split_merge_matches_reference(H, KH, D, splits):
    """Partial states over K5's split ranges, merged by the merge's plain
    version, against the plain kernel and the reference's oracle (f32,
    2e-5): lengths of 1, inside a split, on a split boundary, shorter
    than one split, the whole table and past it (clipped), with empty
    splits among them."""
    rng = np.random.default_rng(H * D + splits)
    B, page, mp, pool = 7, 16, 32, 96
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, "float32") for s in (
        (B, H, D), (KH, pool, page, D), (KH, pool, page, D)))
    pt = np.stack([rng.choice(pool, size=mp, replace=False)
                   for _ in range(B)]).astype(np.int32)
    ln = np.array([1, 127, 128, 129, 300, 512, 700], np.int32)
    table, lengths = torch.from_numpy(pt), torch.from_numpy(ln)
    m, l, acc = _split_partials(qt, kt, vt, table, lengths, splits)
    if splits > 1:
        assert bool((l == 0).any())     # some splits are empty
    got = K.paged_attention_merge_plain(m, l, acc)
    assert torch.isfinite(got).all()
    want = K.paged_attention_plain(qt, kt, vt, table, lengths)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    oracle = ref.paged_attention_ref(qj, kj, vj, jnp.asarray(pt),
                                     jnp.asarray(ln))
    np.testing.assert_allclose(got.numpy(), _np(oracle), rtol=2e-5,
                               atol=2e-5)


def test_paged_merge_of_empty_splits_is_zero_not_nan():
    m = torch.full((1, 2, 3), K.NEG_INF)
    got = K.paged_attention_merge_plain(m, torch.zeros((1, 2, 3)),
                                        torch.zeros((1, 2, 3, 8)))
    assert torch.equal(got, torch.zeros((1, 2, 8)))


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda_device():
    """The card, decided at run time; skips on CPU-only hosts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_matches_plain(cuda_device, dtype):
    """bf16 runs the tensor-core route, f32 the CUDA-core one: both at
    the engines' full-width shapes, ragged Sq/Sk (6, 130, 1,000), windows
    that cross 64-key tiles, and every head dim."""
    rng = np.random.default_rng(11)
    for (B, H, KH, Sq, Sk, D), causal, window in [
            ((1, 32, 4, 1024, 1024, 64), True, 0),     # tinyllama
            ((1, 32, 32, 1024, 1024, 80), True, 0),    # zamba2
            ((2, 8, 2, 130, 130, 64), True, 0), ((1, 4, 4, 77, 77, 16),
                                                 False, 0),
            ((1, 8, 1, 200, 200, 128), True, 48),
            ((2, 4, 2, 64, 64, 32), True, 0),
            ((1, 32, 32, 130, 130, 80), True, 0),
            ((1, 8, 2, 6, 6, 64), True, 0), ((1, 4, 2, 1000, 1000, 80),
                                             True, 100),
            ((1, 4, 1, 1000, 1000, 16), True, 0),
            ((1, 4, 4, 130, 1000, 32), False, 0),
            ((1, 4, 2, 70, 1000, 128), True, 0),
            ((2, 4, 4, 1000, 1000, 128), True, 300)]:
        q, k, v = (_pair(rng, s, dtype)[1].to(cuda_device) for s in (
            (B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D)))
        before = fleet.LAUNCHES["flash_attention"]
        got = K.flash_attention(q, k, v, causal=causal, window=window)
        assert fleet.LAUNCHES["flash_attention"] == before + 1
        want = K.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
def test_cuda_paged_matches_plain(cuda_device, dtype):
    """All three dtype codes ("mixed": f32 q, bf16 pools); G = 8 and
    G = 1; B = 1; random pages; lengths that end inside, on and just
    past a 128-token round, that fill K5's splits exactly, less or more
    by one token, and the whole table."""
    qd, pd = ("float32", "bfloat16") if dtype == "mixed" else (dtype, dtype)
    for B, KH, D in ((8, 4, 64), (8, 32, 80), (1, 4, 64), (5, 8, 128),
                     (3, 2, 16)):
        rng = np.random.default_rng(12 + D)
        H, page, mp, pool = 32, 16, 80, 4 * 80
        ctas = B * KH * -(-(H // KH) // K.paged_rows(H // KH))
        splits = K.paged_splits(ctas, mp * page,
                                torch.cuda.get_device_properties(
                                    cuda_device).multi_processor_count)
        _, (q, kp, vp, table, _) = _paged_inputs(rng, B, H, KH, D, page,
                                                 pool, mp, qd)
        if pd != qd:
            kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
        r, full = K.PAGED_ROUND, K.PAGED_ROUND * splits
        ln = [1, r - 1, r, r + 1, full - 1, full, full + 1, mp * page]
        lengths = torch.tensor(ln[:B] if B > 1 else [full + 1],
                               dtype=torch.int32)
        args = [t.to(cuda_device) for t in (q, kp, vp, table, lengths)]
        before = fleet.LAUNCHES["paged_attention"]
        got = K.paged_attention(*args)
        assert fleet.LAUNCHES["paged_attention"] == before + 1
        torch.testing.assert_close(got.float(),
                                   K.paged_attention_plain(*args).float(),
                                   **tol(qd if pd == qd else "bfloat16"))
