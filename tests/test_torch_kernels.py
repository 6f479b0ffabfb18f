"""The fleet kernels' plain versions against the JAX package's bodies,
on the same keys and inputs (CPU), and the CUDA kernels against their
plain versions (on a card only).

Tolerances: K1 is float32 division and pow — rtol 2e-5 against the
float64 numpy path, 1e-6 against the Pallas kernel in interpret mode.
K2 draws the same threefry bits and uniforms as jax.random.normal; only
erfinv/exp differ by a few f32 ulp, so latencies agree at rtol 1e-5 and
SLO flags agree wherever |lat/slo - 1| > 1e-5. K3 is held to the
Poisson distribution (mean and variance within 5 sigma)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as RS
import repro_torch.sim as PS
from repro.sim.engines import jax_backend as jb
from repro_torch.kernels import fleet
from repro_torch.sim.engines import torch_backend as tb

LAT_RTOL = 1e-5


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x, dtype))


def _keys(rng, n):
    """(n, 2) uint32 key words and their int32 tensors."""
    keys = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64
                        ).astype(np.uint32)
    return (keys, _t(keys[:, 0].view(np.int32), np.int32),
            _t(keys[:, 1].view(np.int32), np.int32))


# ------------------------------------------------------------------ K1
def _game_batch():
    fb = PS.FleetBatch(PS.make_game_fleet(12, np.random.default_rng(3)))
    units = np.arange(1, 13, dtype=np.int64)
    demand = fb.demand_rates(0, 120)
    capacity = np.maximum(units, 1) * fb.unit_rate
    return fb, units, demand, capacity


def test_latency_scale_matches_numpy_and_pallas():
    fb, units, demand, capacity = _game_batch()
    args32 = [x.astype(np.float32) for x in
              (fb.base_pf, fb.alpha, demand, capacity)]
    got = fleet.latency_scale(*(_t(a, np.float32) for a in args32)).numpy()
    np.testing.assert_allclose(got, fb.latency_scale(units, 0, 120),
                               rtol=2e-5)
    pallas = np.asarray(jb._pallas_latency_scale(
        *(jnp.asarray(a) for a in args32), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-6)


def test_latency_scale_below_capacity_is_exactly_base():
    base = _t([0.5, 2.0], np.float32)
    got = fleet.latency_scale(base, _t([1.3, 1.3], np.float32),
                              _t([[1.0, 3.0], [1.0, 1.0]], np.float32),
                              _t([2.0, 4.0], np.float32))
    assert got[0, 0] == 0.5 and got[1].tolist() == [2.0, 2.0]
    assert got[0, 1] == pytest.approx(0.5 * 1.5 ** 1.3, rel=1e-6)


# ---------------------------------------------------------------- keys
def test_key_words_bitwise_equal_to_reference():
    fleet_r = RS.make_game_fleet(9, np.random.default_rng(1))
    fleet_p = PS.make_game_fleet(9, np.random.default_rng(1))
    node_r = RS.EdgeNodeSim(fleet_r, RS.SimConfig(engine="jax", seed=123))
    node_p = PS.EdgeNodeSim(fleet_p, PS.SimConfig(
        engine="torch", seed=123, backend_options={"device": "cpu"}))
    ref, got = jb.JaxFleetStepper([node_r]), tb.TorchFleetStepper([node_p])
    ref._rebuild()
    got._rebuild()
    # the reference pads rows to its device count; tenant rows come first
    T = len(fleet_p)
    assert np.array_equal(got._k0, ref._k0[:T])
    assert np.array_equal(got._k1, ref._k1[:T])
    for t0 in (0, 60, 1140, 2 ** 31 + 5):
        for kind in (0, 1):
            rk = ref._row_keys(t0, np.uint32(kind))[:T]
            assert np.array_equal(rk[:, 0], got._k0)
            assert np.array_equal(
                rk[:, 1], got._k1 ^ np.uint32(tb._chunk_word(t0, kind)))
    x = np.random.default_rng(2).integers(0, 2 ** 32, 64, dtype=np.uint64
                                          ).astype(np.uint32)
    assert np.array_equal(tb._mix32(x), jb._mix32(x))
    assert tb._mix32(np.uint32(7)) == jb._mix32(np.uint32(7))


def test_threefry_bits_equal_jax_random_bits():
    import jax

    keys, k0, k1 = _keys(np.random.default_rng(5), 16)
    ref = np.asarray(jax.vmap(lambda k: jax.random.bits(
        jax.random.wrap_key_data(k), (200,), jnp.uint32))(jnp.asarray(keys)))
    key0, key1 = fleet._row_keys(k0, k1, 0)
    got = fleet.threefry_bits(key0, key1, 0, torch.arange(200)[None, :])
    assert np.array_equal(got.numpy().astype(np.uint32), ref)


# ------------------------------------------------------------------ K2
def _draw_inputs(seed, rows, cols):
    rng = np.random.default_rng(seed)
    keys, k0, k1 = _keys(rng, rows)
    scale = rng.uniform(0.05, 3.0, rows).astype(np.float32)
    sigma = rng.choice([0.08, 0.3], rows).astype(np.float32)
    # SLOs near the latency scale so a fair share of cells violate
    slo = (scale * rng.uniform(0.9, 1.3, rows)).astype(np.float32)
    return rng, keys, k0, k1, scale, sigma, slo


def _assert_draw_close(got, ref, slo, mask):
    lat, viol, lsum, cnt = (x.numpy() for x in got)
    rlat, rviol, rlsum, rcnt = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(lat, rlat, rtol=LAT_RTOL)
    band = np.abs(rlat / slo[:, None] - 1.0) <= LAT_RTOL
    assert np.array_equal(viol[~band], rviol[~band])
    assert rviol.any() and (~rviol).any()
    np.testing.assert_allclose(lsum, rlsum, rtol=LAT_RTOL)
    assert np.all(np.abs(cnt - rcnt) <= (band & mask).sum(axis=1))


def test_row_draw_dense_matches_dense_impl():
    rng, keys, k0, k1, scale, sigma, slo = _draw_inputs(1, 40, 120)
    active = rng.random((40, 120)) < 0.6
    ref = jb._dense_impl(120, jnp.asarray(keys), jnp.asarray(active),
                         jnp.asarray(scale), jnp.asarray(sigma),
                         jnp.asarray(slo))
    got = fleet.row_draw("dense", k0, k1, 0, sigma=_t(sigma, np.float32),
                         scale=_t(scale, np.float32),
                         slo=_t(slo, np.float32), active=torch.from_numpy(
                             active))
    _assert_draw_close(got, ref, slo, active)


def test_row_draw_fused_matches_fused_impl():
    rng, keys, k0, k1, scale, sigma, slo = _draw_inputs(2, 30, 256)
    totals = rng.integers(0, 257, 30).astype(np.int32)
    ref = jb._fused_impl(256, jnp.asarray(keys), jnp.asarray(totals),
                         jnp.asarray(scale), jnp.asarray(sigma),
                         jnp.asarray(slo))
    got = fleet.row_draw("fused", k0, k1, 0, cols=256,
                         sigma=_t(sigma, np.float32),
                         scale=_t(scale, np.float32),
                         slo=_t(slo, np.float32),
                         totals=_t(totals, np.int32))
    _assert_draw_close(got, ref, slo, np.arange(256)[None, :]
                       < totals[:, None])


def test_row_draw_jitter_matches_jitter_impl():
    _, keys, k0, k1, _, sigma, _ = _draw_inputs(3, 25, 192)
    ref = np.asarray(jb._jitter_impl(192, jnp.asarray(keys),
                                     jnp.asarray(sigma)))
    got = fleet.row_draw("jitter", k0, k1, 0, cols=192,
                         sigma=_t(sigma, np.float32))
    assert got.dtype == torch.float32 and got.shape == (25, 192)
    np.testing.assert_allclose(got.numpy(), ref, rtol=LAT_RTOL)


def test_row_draw_chunk_word_is_xored_into_second_key():
    _, keys, k0, k1, _, sigma, _ = _draw_inputs(4, 8, 64)
    ch = 0x9E3779B9
    shifted = _t((keys[:, 1] ^ np.uint32(ch)).view(np.int32), np.int32)
    a = fleet.row_draw("jitter", k0, k1, ch, cols=64,
                       sigma=_t(sigma, np.float32))
    b = fleet.row_draw("jitter", k0, shifted, 0, cols=64,
                       sigma=_t(sigma, np.float32))
    assert torch.equal(a, b)


def test_row_permutation_permutes_outputs_only():
    rng, keys, k0, k1, scale, sigma, slo = _draw_inputs(6, 24, 128)
    totals = _t(rng.integers(0, 129, 24), np.int32)
    kw = dict(cols=128, sigma=_t(sigma, np.float32),
              scale=_t(scale, np.float32), slo=_t(slo, np.float32))
    base = fleet.row_draw("fused", k0, k1, 77, totals=totals, **kw)
    perm = torch.from_numpy(rng.permutation(24))
    moved = fleet.row_draw("fused", k0[perm], k1[perm], 77,
                           totals=totals[perm],
                           **{k: (v[perm] if torch.is_tensor(v) else v)
                              for k, v in kw.items()})
    for x, y in zip(base, moved):
        assert torch.equal(x[perm], y)
    lam = _t(rng.uniform(0.5, 60.0, (24, 30)), np.float32)
    counts = fleet.poisson(k0, k1, 5, lam)
    assert torch.equal(counts[perm], fleet.poisson(k0[perm], k1[perm], 5,
                                                   lam[perm]))


# ------------------------------------------------------------------ K3
@pytest.mark.parametrize("lam", [0.3, 3.0, 12.0, 54.0, 150.0])
def test_poisson_mean_and_variance(lam):
    n_rows, n_cols = 200, 100
    _, k0, k1 = _keys(np.random.default_rng(int(lam * 10)), n_rows)
    draws = fleet.poisson(k0, k1, 3, torch.full((n_rows, n_cols), lam))
    assert draws.dtype == torch.int32 and bool((draws >= 0).all())
    x = draws.double().numpy().ravel()
    n = x.size
    assert abs(x.mean() - lam) < 5 * np.sqrt(lam / n)
    assert abs(x.var(ddof=1) - lam) < 5 * np.sqrt((lam + 2 * lam ** 2) / n)


def test_poisson_zero_rate_and_branches():
    _, k0, k1 = _keys(np.random.default_rng(9), 4)
    lam = _t([[0.0, 99.5, 100.0, 250.0]] * 4, np.float32)
    out = fleet.poisson(k0, k1, 0, lam)
    assert bool((out[:, 0] == 0).all())
    assert bool((out[:, 1:] > 40).all())


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda_device():
    """The card, decided at run time; skips on CPU-only hosts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    rng, keys, k0, k1, scale, sigma, slo = _draw_inputs(8, 500, 120)
    d = cuda_device
    args = [_t(x, np.float32).to(d) for x in
            (scale, sigma, slo)]
    active = torch.from_numpy(rng.random((500, 120)) < 0.5).to(d)
    k0d, k1d = k0.to(d), k1.to(d)
    got = fleet.row_draw("dense", k0d, k1d, 11, scale=args[0],
                         sigma=args[1], slo=args[2], active=active)
    ref = fleet.row_draw_plain("dense", k0d, k1d, 11, 120, args[0],
                               args[1], args[2], active, None)
    torch.testing.assert_close(got[0], ref[0], rtol=LAT_RTOL, atol=0)
    lam = _t(rng.uniform(0.0, 160.0, (500, 120)), np.float32).to(d)
    assert torch.equal(fleet.poisson(k0d, k1d, 3, lam),
                       fleet.poisson_plain(k0d, k1d, 3, lam))
    fb, _, demand, capacity = _game_batch()
    a = [_t(x, np.float32).to(d) for x in
         (fb.base_pf, fb.alpha, demand, capacity)]
    torch.testing.assert_close(fleet.latency_scale(*a),
                               fleet.latency_scale_plain(*a), rtol=1e-6,
                               atol=0)
