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


# ------------------------------------------------- K2 layout (CPU side)
def _tree(a):
    """Lane 0's value after five ``__shfl_down_sync`` steps over a
    (rows, 32) f32 tensor."""
    for o in (16, 8, 4, 2, 1):
        a = a[:, :o] + a[:, o:2 * o]
    return a[:, 0]


def _emulated_row_sums(lat, mask, layout=fleet.ROW_DRAW_LAYOUT):
    """K2's f32 order for the masked row sums: each lane of a short
    row's warp (each thread of a wide row's CTA) adds its V consecutive
    cells in column order, pass after pass; then the shuffle tree, and
    for a wide row one more tree over the warps' sums."""
    rows, cols = lat.shape
    wide = cols > layout.short_max
    v = layout.wide_v if wide else layout.short_v
    threads = 32 * (layout.wide_warps if wide else 1)
    passes = -(-cols // (threads * v))
    cells = torch.zeros((rows, passes * threads * v), dtype=torch.float32,
                        device=lat.device)
    cells[:, :cols] = torch.where(mask, lat, torch.zeros_like(lat))
    cells = cells.view(rows, passes, threads, v)
    acc = torch.zeros((rows, threads), dtype=torch.float32, device=lat.device)
    for p in range(passes):
        for j in range(v):
            acc = acc + cells[:, p, :, j]
    warps = torch.stack([_tree(acc[:, 32 * w:32 * w + 32])
                         for w in range(threads // 32)], dim=1)
    if not wide:
        return warps[:, 0]
    lanes = torch.zeros((rows, 32), dtype=torch.float32, device=lat.device)
    lanes[:, :warps.shape[1]] = warps
    return _tree(lanes)


def _plain_draw(mode, seed, rows, cols, device="cpu"):
    """Inputs for K2 on ``device`` and the plain version's outputs."""
    rng, _, k0, k1, scale, sigma, slo = _draw_inputs(seed, rows, cols)
    kw = dict(sigma=_t(sigma, np.float32).to(device),
              scale=_t(scale, np.float32).to(device),
              slo=_t(slo, np.float32).to(device))
    if mode == "dense":
        kw["active"] = torch.from_numpy(rng.random((rows, cols)) < 0.6
                                        ).to(device)
    elif mode == "fused":
        kw["totals"] = _t(rng.integers(0, cols + 1, rows), np.int32
                          ).to(device)
    else:
        del kw["scale"], kw["slo"]
    k0, k1 = k0.to(device), k1.to(device)
    ref = fleet.row_draw_plain(mode, k0, k1, 21, cols, kw.get("scale"),
                               kw["sigma"], kw.get("slo"), kw.get("active"),
                               kw.get("totals"))
    return k0, k1, kw, ref


def _mask(mode, kw, cols):
    if mode == "dense":
        return kw["active"]
    ar = torch.arange(cols, device=kw["totals"].device)
    return ar[None, :] < kw["totals"][:, None]


@pytest.mark.parametrize("mode,rows,cols,v", [
    ("dense", 64, 120, 4), ("dense", 64, 120, 2), ("dense", 33, 509, 4),
    ("fused", 12, 6848, 4), ("fused", 12, 6848, 2), ("fused", 9, 1000, 4)])
def test_row_draw_sum_order_matches_plain(mode, rows, cols, v):
    """The kernel's order of the row sums (lane partials of V cells, the
    shuffle tree, for wide rows the tree over the warps) stays within
    1e-5 of the plain version's torch.sum."""
    layout = fleet.ROW_DRAW_LAYOUT._replace(short_v=v, wide_v=v)
    _, _, kw, ref = _plain_draw(mode, 30 + rows, rows, cols)
    lat, _, lat_sum, _ = ref
    got = _emulated_row_sums(lat, _mask(mode, kw, cols), layout)
    assert got.dtype == torch.float32 and got.shape == (rows,)
    torch.testing.assert_close(got, lat_sum, rtol=1e-5, atol=0)


def test_row_draw_odd_cols_and_sliced_active():
    rng, keys, k0, k1, scale, sigma, slo = _draw_inputs(12, 9, 121)
    active = torch.from_numpy(rng.random((9, 121)) < 0.5)
    kw = dict(sigma=_t(sigma, np.float32)[1:], scale=_t(scale, np.float32)[1:],
              slo=_t(slo, np.float32)[1:])
    lat, viol, lat_sum, cnt = fleet.row_draw("dense", k0[1:], k1[1:], 5,
                                             active=active[1:], **kw)
    assert lat.shape == viol.shape == (8, 121)
    assert lat.dtype == torch.float32 and viol.dtype == torch.bool
    assert lat_sum.shape == cnt.shape == (8,) and cnt.dtype == torch.int32
    full = fleet.row_draw("dense", k0, k1, 5, active=active,
                          sigma=_t(sigma, np.float32),
                          scale=_t(scale, np.float32),
                          slo=_t(slo, np.float32))
    for x, y in zip((lat, viol, lat_sum, cnt), full):
        assert torch.equal(x, y[1:])
    with pytest.raises(ValueError, match="active"):
        fleet.row_draw("dense", k0[1:], k1[1:], 5,
                       active=active[1:].to(torch.uint8), **kw)
    with pytest.raises(ValueError, match="active"):
        fleet.row_draw("dense", k0[1:], k1[1:], 5, active=active[2:], **kw)
    with pytest.raises(ValueError, match="totals"):
        fleet.row_draw("fused", k0[1:], k1[1:], 5, cols=121,
                       totals=_t(np.zeros(8), np.int64), **kw)


def test_row_draw_layout_is_checked():
    _, _, k0, k1, _, sigma, _ = _draw_inputs(13, 4, 8)
    for bad in (dict(short_v=3), dict(wide_v=1), dict(short_warps=0),
                dict(wide_warps=17)):
        with pytest.raises(ValueError, match="layout"):
            fleet.row_draw("jitter", k0, k1, 0, cols=8,
                           sigma=_t(sigma, np.float32),
                           layout=fleet.RowDrawLayout(**bad))


def test_latency_scale_bound_counts_bytes_and_operations():
    bytes_ms = 1e3 * 4 * (2 * 1.2e6 + 3e4) / 3.35e12
    ms, by = fleet.latency_scale_bound_ms(10_000, 120, pow_cells=0)
    assert by == "bytes" and ms == pytest.approx(bytes_ms)
    # the game fleet's chunk: about 30 % of the cells run powf
    ms, by = fleet.latency_scale_bound_ms(10_000, 120, pow_cells=360_000)
    assert by == "bytes" and ms == pytest.approx(bytes_ms)
    ms, by = fleet.latency_scale_bound_ms(10_000, 120, pow_cells=1_200_000)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 1.2e6 * (
        fleet.LATENCY_SCALE_F32_OPS + fleet.POWF_F32_OPS)
        / fleet.LANE_OPS_PER_S)


def _fma(a, b, c):
    """fma(a, b, c) rounded once, as the card's DFMA."""
    from fractions import Fraction

    return float(Fraction(a) * Fraction(b) + Fraction(c))


def test_poisson_reciprocal_division_rounds_as_ieee():
    """K3's step divides x = p·lam by k as q = RN(x·RN(1/k)), then
    q + RN(1/k)·(x − k·q) by two FMAs: the correctly rounded x / k for
    every k its table holds, on random x over the search's range and on
    the doubles nearest k times a midpoint between two doubles (quotients
    next to a tie)."""
    from fractions import Fraction

    rng = np.random.default_rng(17)
    for k in range(1, 273):
        y = 1.0 / k
        xs = list(np.ldexp(rng.uniform(0.5, 1.0, 24),
                           rng.integers(-150, 8, 24)))
        for m, e in zip(rng.integers(2 ** 52, 2 ** 53, 8),
                        rng.integers(-150, 8, 8)):
            tie = float(k * Fraction(2 * int(m) + 1, 2 ** 53)
                        * Fraction(2) ** int(e))
            xs += [tie, np.nextafter(tie, 0.0), np.nextafter(tie, np.inf)]
        for x in map(float, xs):
            q = x * y
            assert _fma(_fma(-float(k), q, x), y, q) == x / k, (k, x)


@pytest.mark.parametrize("case", ["mixed", "zero", "game"])
def test_poisson_bound_counts_bytes_and_pipes(case):
    """The terms follow the SASS counts: an inversion cell costs a
    set-up and one step a unit of its count, a PTRS cell one set-up, a
    zero-rate cell only its bytes; the bound is the largest term."""
    rng = np.random.default_rng(5)
    if case == "mixed":
        lam = np.array([[0.0, 2.0, 50.0], [150.0, 0.0, 7.0]], np.float32)
        counts = np.array([[0, 3, 40], [151, 0, 9]], np.int32)
        steps, setups = 3 + 40 + 9, 4
    elif case == "zero":
        lam = np.zeros((4, 8), np.float32)
        counts = np.zeros((4, 8), np.int32)
        steps, setups = 0, 0
    else:
        lam = rng.uniform(0.5, 54.0, (100, 120)).astype(np.float32)
        counts = rng.poisson(lam)
        steps, setups = int(counts.sum()), lam.size
    terms = fleet.poisson_bound_terms(lam, counts)
    assert len(terms) == 3
    t_bytes, t_f64, t_alu = terms
    assert t_bytes == pytest.approx(
        1e3 * (8 * lam.size + 8 * lam.shape[0]) / 3.35e12)
    for t, rate, i in ((t_f64, fleet.F64_OPS_PER_S, 0),
                       (t_alu, fleet.ALU_OPS_PER_S, 1)):
        assert t == pytest.approx(1e3 * (
            steps * fleet.POISSON_STEP_OPS[i]
            + setups * fleet.POISSON_SETUP_OPS[i]) / rate)
    ms, by = fleet.poisson_bound_ms(lam, counts)
    assert ms == max(terms)
    # no draws: only the bytes are left; the game fleet's rates: the
    # search's f64 steps dominate the threefry rounds
    assert by == ("bytes" if case == "zero" else "operations")
    if case == "game":
        assert ms == t_f64


@pytest.mark.parametrize("bad", [-1.0, -1e30, float("-inf"), float("nan")])
def test_poisson_negative_and_nan_rates_draw_zero(bad):
    """A rate below 0 or NaN draws 0, as a rate of 0 does, beside cells
    that draw in both branches."""
    _, k0, k1 = _keys(np.random.default_rng(10), 3)
    lam = _t([[bad, 5.0, bad, 120.0]] * 3, np.float32)
    out = fleet.poisson(k0, k1, 2, lam)
    assert out.dtype == torch.int32
    assert bool((out[:, 0] == 0).all()) and bool((out[:, 2] == 0).all())
    assert bool((out[:, 3] > 60).all())


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda_device():
    """The card, decided at run time; skips on CPU-only hosts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the card)")
    return torch.device("cuda")


def _assert_draw_equal(mode, got, ref, kw, cols, layout):
    """lat/viol bit for bit, exact counts, row sums within 1e-5 of the
    plain version and equal to the kernel's own order emulated."""
    if mode == "jitter":
        assert torch.equal(got, ref)
        return
    lat, viol, lat_sum, cnt = got
    assert torch.equal(lat, ref[0]) and torch.equal(viol, ref[1])
    assert torch.equal(cnt, ref[3])
    torch.testing.assert_close(lat_sum, ref[2], rtol=1e-5, atol=0)
    assert torch.equal(lat_sum, _emulated_row_sums(
        ref[0], _mask(mode, kw, cols), layout))


def _sliced(k0, k1, kw):
    """The same inputs one row in: every base pointer moves one row."""
    return k0[1:], k1[1:], {k: v[1:] for k, v in kw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "fused", "jitter"])
@pytest.mark.parametrize("cols", [1, 3, 4, 64, 120, 127, 128, 129, 255, 256,
                                  257, 6848])
def test_cuda_row_draw_matches_plain(cuda_device, mode, cols):
    layout = fleet.ROW_DRAW_LAYOUT
    for rows in (1, 7, 8, 9, 500):
        k0, k1, kw, ref = _plain_draw(mode, rows + cols, rows, cols,
                                      cuda_device)
        got = fleet.row_draw(mode, k0, k1, 21, cols=cols, **kw)
        _assert_draw_equal(mode, got, ref, kw, cols, layout)
        if rows == 1:
            continue
        # row slices: active starts cols bytes in, k0/k1/... one word in
        k0s, k1s, kws = _sliced(k0, k1, kw)
        got = fleet.row_draw(mode, k0s, k1s, 21, cols=cols, **kws)
        refs = (ref[1:] if mode == "jitter" else tuple(x[1:] for x in ref))
        _assert_draw_equal(mode, got, refs, kws, cols, layout)
    if mode == "dense":
        # active one byte off a word: the scalar path on any cols
        rows = 9
        k0, k1, kw, ref = _plain_draw(mode, 99 + cols, rows, cols,
                                      cuda_device)
        buf = torch.zeros(rows * cols + 1, dtype=torch.bool,
                          device=cuda_device)
        buf[1:] = kw["active"].reshape(-1)
        kw["active"] = buf[1:].view(rows, cols)
        got = fleet.row_draw(mode, k0, k1, 21, **kw)
        _assert_draw_equal(mode, got, ref, kw, cols, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [
    fleet.RowDrawLayout(short_v=v, short_warps=w, wide_v=v, wide_warps=w)
    for v in (2, 4) for w in (4, 8, 16)] + [
    fleet.RowDrawLayout(short_max=0), fleet.RowDrawLayout(short_max=1 << 20)],
    ids=lambda lay: "-".join(map(str, lay)))
def test_cuda_row_draw_layouts_match_plain(cuda_device, layout):
    """Every layout the sweep times gives the same outputs."""
    for mode in ("dense", "fused", "jitter"):
        for rows, cols in ((37, 120), (9, 130), (5, 6848)):
            k0, k1, kw, ref = _plain_draw(mode, rows, rows, cols,
                                          cuda_device)
            got = fleet.row_draw(mode, k0, k1, 21, cols=cols,
                                 layout=layout, **kw)
            _assert_draw_equal(mode, got, ref, kw, cols, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 120, 121])
def test_cuda_latency_scale_matches_plain(cuda_device, W):
    rng = np.random.default_rng(W)
    T = 37
    capacity = rng.uniform(5.0, 50.0, T)
    # rho on both sides of 1
    demand = capacity[:, None] * rng.uniform(0.3, 2.5, (T, W))
    a = [_t(x, np.float32).to(cuda_device) for x in
         (rng.uniform(0.01, 0.2, T), rng.uniform(0.5, 2.5, T), demand,
          capacity)]
    got = fleet.latency_scale(*a)
    assert torch.equal(got, fleet.latency_scale_plain(*a))
    rho = a[2] / a[3][:, None]
    assert bool((rho > 1).any()) and bool((rho <= 1).any())
    # demand one float off 16 bytes: the scalar path
    buf = torch.zeros(T * W + 1, device=cuda_device)
    buf[1:] = a[2].reshape(-1)
    a[2] = buf[1:].view(T, W)
    assert torch.equal(fleet.latency_scale(*a),
                       fleet.latency_scale_plain(*a))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dense", "poisson", "latency_scale"])
def test_cuda_kernels_match_plain_versions(cuda_device, kernel):
    rng, keys, k0, k1, scale, sigma, slo = _draw_inputs(8, 500, 120)
    d = cuda_device
    k0d, k1d = k0.to(d), k1.to(d)
    if kernel == "dense":
        args = [_t(x, np.float32).to(d) for x in (scale, sigma, slo)]
        active = torch.from_numpy(rng.random((500, 120)) < 0.5).to(d)
        got = fleet.row_draw("dense", k0d, k1d, 11, scale=args[0],
                             sigma=args[1], slo=args[2], active=active)
        ref = fleet.row_draw_plain("dense", k0d, k1d, 11, 120, args[0],
                                   args[1], args[2], active, None)
        for x, y in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
            assert torch.equal(x, y)
        torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=0)
    elif kernel == "poisson":
        lam = _t(rng.uniform(0.0, 160.0, (500, 120)), np.float32).to(d)
        assert torch.equal(fleet.poisson(k0d, k1d, 3, lam),
                           fleet.poisson_plain(k0d, k1d, 3, lam))
    else:
        fb, _, demand, capacity = _game_batch()
        a = [_t(x, np.float32).to(d) for x in
             (fb.base_pf, fb.alpha, demand, capacity)]
        torch.testing.assert_close(fleet.latency_scale(*a),
                                   fleet.latency_scale_plain(*a), rtol=1e-6,
                                   atol=0)


def _poisson_inputs(seed, rows, cols, lam, device):
    _, k0, k1 = _keys(np.random.default_rng(seed), rows)
    return (k0.to(device), k1.to(device),
            _t(lam, np.float32).to(device))


#: rates that mix every branch inside one warp: zero, small, just under
#: the inversion's limit, PTRS, negative and NaN (both draw 0)
_MIXED = np.array([0.0, 0.3, 3.0, 25.0, 99.99, 100.0, 150.0, 54.0, -1.0,
                   float("nan"), 0.49, 12.0], np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 31, 32, 33, 120, 121])
def test_cuda_poisson_matches_plain(cuda_device, cols):
    for rows in (1, 7, 33, 500):
        rng = np.random.default_rng(rows * 1000 + cols)
        for lam in (rng.uniform(0.0, 160.0, (rows, cols)),
                    rng.choice(_MIXED, (rows, cols))):
            k0, k1, lt = _poisson_inputs(rows + cols, rows, cols, lam,
                                         cuda_device)
            ref = fleet.poisson_plain(k0, k1, 3, lt)
            assert torch.equal(fleet.poisson(k0, k1, 3, lt), ref)
            if rows > 1:
                # row slices: every base pointer one row in
                assert torch.equal(fleet.poisson(k0[1:], k1[1:], 3, lt[1:]),
                                   ref[1:])


@pytest.mark.cuda
def test_cuda_poisson_game_rates_and_row_order(cuda_device):
    """The game fleet's rates at the kernels phase's (10^4, 120), and the
    counts of permuted rows are the permuted counts."""
    game = PS.make_game_fleet(10_000, np.random.default_rng(42))
    lam = type(game[0]).batch_arrival_lam(game, 0, 120)
    k0, k1, lt = _poisson_inputs(42, len(game), 120, lam, cuda_device)
    got = fleet.poisson(k0, k1, 7, lt)
    assert torch.equal(got, fleet.poisson_plain(k0, k1, 7, lt))
    perm = torch.from_numpy(np.random.default_rng(1).permutation(len(game))
                            ).to(cuda_device)
    assert torch.equal(fleet.poisson(k0[perm], k1[perm], 7, lt[perm]),
                       got[perm])
