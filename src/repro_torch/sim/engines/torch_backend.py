"""``engine="torch"``: the mega-scale fleet engine on hand-written GPU
kernels.

Ports the JAX package's ``engine="jax"`` (``JaxFleetStepper``): the
whole fleet's arrival draws, jitter draws, latencies, SLO flags and row
reductions run as one (rows × requests) pass of the CUDA kernels in
:mod:`repro_torch.kernels.fleet`, with only the ragged per-request
bookkeeping (flat extraction, per-second violation attribution,
Monitor feeds) left to numpy. On the CPU (``device="cpu"``) the
kernels' plain torch versions run instead; they draw the same bits.

RNG scheme (``counter-threefry``): every draw comes from a
threefry2x32-20 counter stream whose 64-bit key is a vectorized
splitmix32 mix::

    k0 = mix32(crc32(tenant) ^ mix32(seed))
    k1 = mix32(crc32(tenant)·φ32 + seed) ^ mix32(2·chunk_t0 + kind)

with ``kind`` 0 for arrival counts and 1 for jitter — the same key
words as the JAX engine, bit for bit. Jitter draws use JAX's
partitionable counter layout and uniform mapping, so a row's normals
equal ``jax.random.normal`` up to the erfinv implementation (a few
1e-6). A tenant's draws depend only on (seed, tenant name, chunk
start, draw kind) — NOT on which node hosts it, how rows are ordered,
or how many RNG worker threads exist. Repeated runs are bitwise
identical to each other.

Equivalence contract (``tolerance``):

1. **Against the numpy trio** (scalar/vectorized/batched): different
   random streams (same Poisson(λ) and lognormal(0, σ) distributions,
   different bits), float32 latency math, and dense row reductions in
   place of per-tenant pairwise sums — so results agree statistically,
   not bitwise.
2. **Against ``engine="jax"``**: identical keys and jitter uniforms.
   Stream fleets (closed-form arrivals) therefore match almost exactly
   — only SLO comparisons within a few ulp of the threshold can
   resolve differently. Poisson arrivals (game fleets) are drawn by a
   different sampler (inversion below λ = 100, PTRS above; see
   ``csrc/poisson.cu``), so game fleets match statistically.

The deterministic rate math (arrival λ, demand, the latency-scale
factor) is evaluated by the shared float64
:class:`~repro_torch.sim.workload.FleetBatch` path, so controller
inputs differ only through the sampled noise.

Workload support: a class must either declare its arrival counts
RNG-free (``arrival_rng_free = True``, e.g. StreamWorkload's closed
form) or expose its Poisson rate matrix (``batch_arrival_lam``, e.g.
GameWorkload); anything else raises with a pointer at
``engine="batched"``.

``SimConfig.backend_options`` knobs:

* ``device`` (default ``"cuda"``) — where the kernels run; raises when
  CUDA is absent unless ``"cpu"`` is asked for.
* ``scale_kernel`` (bool, default False) — route the latency-scale
  factor through kernel K1 in float32. It is the counterpart of the
  JAX engine's ``pallas`` option and, like it, is off by default so
  that the controller's inputs stay float64.
* ``shard`` (bool, default True) — with more than one visible card
  (:func:`visible_devices`), the rows are padded to a multiple of the
  card count (padded rows carry ``totals = 0`` and are sliced away)
  and each card runs the same kernels on its contiguous slice, as the
  JAX engine shards its rows over devices. The draws are keyed per
  row, so a sharded run equals the one-card run bit for bit.
"""
from __future__ import annotations

import inspect
import zlib

import numpy as np
import torch

from repro_torch.kernels import fleet
from repro_torch.sim.edgesim import FleetStepper
from repro_torch.sim.engines.base import EngineBackend

_KIND_ARRIVAL = 0
_KIND_JITTER = 1
# dense (rows × L) request matrices are padded to a multiple of this (the
# JAX engine's recompile guard; kept so both engines draw the same
# counters)
_LANE = 64
# row-tile cap: ceiling on the dense matrix a single kernel call may
# materialise (cells), so huge-L fleets page through row tiles instead
# of allocating tens of GB
_MAX_CELLS = 1 << 27


def _pad_len(n: int) -> int:
    return -(-n // _LANE) * _LANE if n else 0


# ----------------------------------------------------- key derivation
def _mix32(x: np.ndarray) -> np.ndarray:
    """splitmix32 finalizer, vectorized over uint32 — the host-side key
    mixer. The key is a pure function of (seed, tenant, chunk, kind),
    so draws stay placement- and worker-count-invariant."""
    x = np.uint32(x) if np.isscalar(x) else x.astype(np.uint32, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def _row_key_words(seeds: np.ndarray,
                   names) -> tuple[np.ndarray, np.ndarray]:
    """The two per-row key words (uint32), before the chunk word."""
    crcs = np.array([zlib.crc32(name.encode()) for name in names], np.uint32)
    with np.errstate(over="ignore"):
        k0 = _mix32(crcs ^ _mix32(seeds))
        k1 = _mix32(crcs * np.uint32(0x9E3779B9) + seeds)
    return k0, k1


def _chunk_word(t0: int, kind: int) -> int:
    """The per-(chunk, kind) word XORed into every row's second key."""
    return int(_mix32(np.uint32((2 * t0 + int(kind)) & 0xFFFFFFFF)))


def visible_devices(device) -> list[torch.device]:
    """The cards a sharded fleet spreads its rows over: every visible
    CUDA device for a CUDA ``device``, else ``device`` alone."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _padded(x: np.ndarray, rows: int, fill=0) -> np.ndarray:
    """``x`` with its leading axis padded to ``rows`` with ``fill``."""
    if x.shape[0] == rows:
        return x
    out = np.full((rows,) + x.shape[1:], fill, x.dtype)
    out[:x.shape[0]] = x
    return out


# ------------------------------------------------------------- stepper
class TorchFleetStepper(FleetStepper):
    """Fleet stepper for ``engine="torch"`` (see module docstring for
    the RNG scheme and tolerance contract). Reuses the batched stepper's
    epoch-cached fleet stacking, eviction masks, units gathering and
    node/Monitor accounting; replaces the draw + latency math with the
    fleet kernels, and per-tenant python loops with dense reductions.
    ``users()`` is sampled once per fleet epoch rather than per chunk
    (the built-in workloads report constant users)."""

    def __init__(self, nodes: list):
        super().__init__(nodes)
        opts = nodes[0].cfg.backend_options if nodes else {}
        self._scale_kernel = bool(opts.get("scale_kernel", False))
        self._dev = fleet.check_device(opts.get("device", "cuda"))
        devs = visible_devices(self._dev) if opts.get("shard", True) else []
        self._devs = devs if len(devs) > 1 else [self._dev]

    # -------------------------------------------------------- caches
    def _gather_rngs(self, entries: list) -> None:
        # counter-RNG engine: draws are keyed by (seed, tenant, chunk,
        # kind) at call time — skip the per-tenant Generator gather
        self._arr_rngs = self._jit_rngs = None

    def _rebuild(self) -> None:
        super()._rebuild()
        entries = self._entries
        T = len(entries)
        seeds = np.empty(T, np.uint32)
        for node, sl in zip(self.nodes, self._node_slices):
            seeds[sl] = node.cfg.seed & 0xFFFFFFFF
        k0, k1 = _row_key_words(seeds, [name for _, name, _ in entries])
        self._k0 = k0
        self._k1 = k1
        # the padded row count and each card's contiguous slice of it
        nd = len(self._devs)
        self._Tp = -(-T // nd) * nd
        per = self._Tp // nd
        self._shards = [(dev, d * per, (d + 1) * per)
                        for d, dev in enumerate(self._devs)]
        self._scale_units: np.ndarray | None = None
        self._scale_cache: np.ndarray | None = None
        self._slo32_np = self._slos.astype(np.float32)
        sigma = np.array([wl.jitter_sigma for _, _, wl in entries],
                         np.float32)
        # per card, its rows of: the key words (int32 storage of the
        # unsigned words; the kernels read uint32), sigma and the SLOs
        self._rows = [
            tuple(self._put(x, dev, lo, hi) for x in (
                k0.view(np.int32), k1.view(np.int32), sigma,
                self._slo32_np))
            for dev, lo, hi in self._shards]
        self._users_arr = np.array([wl.users() for _, _, wl in entries],
                                   np.int64)
        self._wan_np = np.asarray(self._wan, np.float64)
        # single-class fleets in row order skip the group scatter copy
        groups = self._batch.groups
        self._single_group_ordered = (
            len(groups) == 1
            and np.array_equal(groups[0][1], np.arange(T)))
        self._counts_buf = None
        self._counts_out_ok = bool(
            self._single_group_ordered
            and "out" in inspect.signature(
                groups[0][0].batch_arrival_counts).parameters)
        self._modes = []
        self._group_idx_d = []
        for cls, idx, sub in self._batch.groups:
            if getattr(cls, "arrival_rng_free", False):
                self._modes.append("free")
            elif callable(getattr(cls, "batch_arrival_lam", None)):
                self._modes.append("poisson")
            else:
                raise ValueError(
                    f"engine='torch' cannot batch arrivals for workload "
                    f"class {cls.__name__}: it neither declares "
                    f"arrival_rng_free nor implements batch_arrival_lam; "
                    f"use engine='batched' for custom workload classes")
            # per card, the group's rows in its slice (local indices)
            self._group_idx_d.append([
                torch.from_numpy(idx[(idx >= lo) & (idx < hi)] - lo).to(dev)
                for dev, lo, hi in self._shards])

    def _put(self, x: np.ndarray, dev, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) of the host array ``x`` (padded with zeros past
        its end) on ``dev``."""
        return torch.from_numpy(np.ascontiguousarray(
            _padded(x, self._Tp)[lo:hi])).to(dev)

    # -------------------------------------------------------- kernels
    def _arrival_counts(self, t0: int, t1: int) -> np.ndarray:
        T, S = len(self._entries), t1 - t0
        groups = self._batch.groups
        if len(groups) == 1 and self._modes[0] == "free" \
                and self._single_group_ordered:
            cls, _, sub = groups[0]
            if self._counts_out_ok:
                buf = self._counts_buf
                if buf is None or buf.shape != (T, S):
                    buf = self._counts_buf = np.empty((T, S), np.int64)
                return cls.batch_arrival_counts(sub, [None] * len(sub),
                                                t0, t1, out=buf)
            return cls.batch_arrival_counts(sub, [None] * len(sub), t0, t1)
        out = np.empty((T, S), np.int64)
        ch = _chunk_word(t0, _KIND_ARRIVAL)
        for (cls, idx, sub), mode, idx_ds in zip(groups, self._modes,
                                                 self._group_idx_d):
            if mode == "free":
                out[idx] = cls.batch_arrival_counts(
                    sub, [None] * len(sub), t0, t1)
                continue
            lam = cls.batch_arrival_lam(sub, t0, t1).astype(np.float32)
            for (dev, lo, hi), (k0, k1, _, _), idx_d in zip(
                    self._shards, self._rows, idx_ds):
                mine = (idx >= lo) & (idx < hi)
                if not mine.any():
                    continue
                lam_d = torch.from_numpy(lam[mine]).to(dev)
                drawn = fleet.poisson(k0[idx_d], k1[idx_d], ch, lam_d)
                out[idx[mine]] = drawn.cpu().numpy()
        return out

    def _latency_scale(self, units: np.ndarray, t0: int,
                       t1: int) -> np.ndarray:
        if not self._scale_kernel:
            # a (T, 1) column means every class reported time-invariant
            # demand, so the factor depends on the units vector alone —
            # reuse it while allocations are unchanged
            cached = self._scale_cache
            if cached is not None and cached.shape[1] == 1 \
                    and np.array_equal(units, self._scale_units):
                return cached
            scale = self._batch.latency_scale(units, t0, t1)
            if scale.shape[1] == 1:
                self._scale_units = units.copy()
                self._scale_cache = scale
            return scale
        fb = self._batch
        demand = fb.demand_rates(t0, t1)
        capacity = np.maximum(units, 1) * fb.unit_rate
        cols = (fb.base_pf, fb.alpha, demand, capacity)
        parts = []
        for dev, lo, hi in self._shards:
            args = [self._put(np.asarray(x, np.float32), dev, lo, hi)
                    for x in cols]
            parts.append(fleet.latency_scale(*args).cpu().numpy())
        return np.concatenate(parts)[:len(units)]

    # ---------------------------------------------------------- step
    # (the public step() lives on FleetStepper: it wraps this body with
    # the optional flight-recorder chunk span and clock-cursor update)
    def _step(self, t0: int, t1: int) -> None:
        epochs = tuple(n._fleet_epoch for n in self.nodes)
        if epochs != self._epochs:
            self._rebuild()
            self._epochs = epochs
        T, S = len(self._entries), t1 - t0
        if T == 0:
            return
        counts = self._arrival_counts(t0, t1)
        totals = counts.sum(axis=1)
        evicted = self._evicted_mask()
        units = self._units_vector(evicted)
        scale = self._latency_scale(units, t0, t1)
        starts = np.zeros(T + 1, np.int64)
        np.cumsum(totals, out=starts[1:])
        L = _pad_len(int(totals.max()))
        slo_rep = np.repeat(self._slo32_np, totals)
        if L == 0:
            flat_lat = np.empty(0, np.float32)
            viol_ts = np.zeros((T, S), np.int64)
            viol_t = np.zeros(T, np.int64)
            lat_sums = np.zeros(T, np.float64)
        else:
            ch = _chunk_word(t0, _KIND_JITTER)
            if scale.shape[1] == 1 and counts.max() <= 1:
                flat_lat, viol_ts, viol_t, lat_sums = self._step_dense(
                    ch, counts, scale, S, T)
            else:
                if scale.shape[1] == 1:
                    flat_lat, vflat, lat_sums, viol_t = self._step_const(
                        ch, totals, scale, L, T)
                else:
                    flat_lat, vflat, lat_sums, viol_t = self._step_varying(
                        ch, totals, starts, scale, counts, slo_rep, L, T)
                vpos = np.flatnonzero(vflat)
                if vpos.size:
                    ends = np.cumsum(counts.ravel())
                    viol_ts = np.bincount(
                        np.searchsorted(ends, vpos, side="right"),
                        minlength=ends.size).reshape(T, S)
                else:
                    viol_ts = np.zeros((T, S), np.int64)
        # Cloud-serviced rows: WAN penalty on the user-visible latencies
        # (after violation counting — evicted rows never enter Eq. 1)
        if flat_lat.size and evicted.any():
            wan_add = np.where(evicted, self._wan_np, 0.0)
            flat_lat = flat_lat + np.repeat(wan_add.astype(np.float32),
                                            totals)
        self._feed_nodes(t0, t1, counts, totals, starts, flat_lat,
                         slo_rep, viol_ts, viol_t, lat_sums, evicted,
                         users_arr=self._users_arr)

    def _row_tiles(self, L: int):
        """(card index, card, lo, hi): row tiles of the padded fleet,
        each within one card's slice, keeping each dense (rows × L) call
        under the cell budget."""
        rows = max(1, _MAX_CELLS // max(L, 1))
        return [(i, dev, lo, min(lo + rows, hi))
                for i, (dev, s_lo, hi) in enumerate(self._shards)
                for lo in range(s_lo, hi, rows)]

    def _draw(self, mode, ch, i, lo, hi, cols, **kw):
        """The K2 draw of rows [lo, hi) on card ``i`` (the caller passes
        the other row tensors already there)."""
        k0, k1, sigma, _ = self._rows[i]
        off = self._shards[i][1]
        sl = slice(lo - off, hi - off)
        return fleet.row_draw(mode, k0[sl], k1[sl], ch, cols=cols,
                              sigma=sigma[sl], **kw)

    def _slo(self, i, lo, hi):
        off = self._shards[i][1]
        return self._rows[i][3][lo - off:hi - off]

    def _step_dense(self, ch, counts, scale, S, T):
        """≤1 request per tenant-second and a time-invariant scale
        column (stream fleets): the (rows × seconds) grid is the request
        layout, so per-second violation attribution falls straight out
        of the kernel and the ragged cumsum/searchsorted tail is
        skipped. This is the mega-scale hot path."""
        Tp = self._Tp
        active = counts > 0
        scale32 = scale[:, 0].astype(np.float32)
        flat_parts = []
        viol_ts = np.empty((Tp, S), bool)
        lat_sums = np.empty(Tp, np.float64)
        viol_t = np.empty(Tp, np.int64)
        for i, dev, lo, hi in self._row_tiles(S):
            act = self._put(active, dev, lo, hi)
            lat_d, viol_d, lsum_d, vt_d = self._draw(
                "dense", ch, i, lo, hi, S,
                scale=self._put(scale32, dev, lo, hi),
                slo=self._slo(i, lo, hi), active=act)
            flat_parts.append(lat_d[act].cpu().numpy())
            viol_ts[lo:hi] = viol_d.cpu().numpy()
            lat_sums[lo:hi] = lsum_d.cpu().numpy()
            viol_t[lo:hi] = vt_d.cpu().numpy()
        flat_lat = (np.concatenate(flat_parts) if len(flat_parts) > 1
                    else flat_parts[0])
        return flat_lat, viol_ts[:T], viol_t[:T], lat_sums[:T]

    def _step_const(self, ch, totals, scale, L, T):
        """Time-invariant scale column: latency, violations and row sums
        all come out of the fused kernel; only the ragged request axis
        is extracted (on the device) for the host."""
        Tp = self._Tp
        scale32 = scale[:, 0].astype(np.float32)
        totals32 = totals.astype(np.int32)
        flat_parts, vflat_parts = [], []
        lat_sums = np.empty(Tp, np.float64)
        viol_t = np.empty(Tp, np.int64)
        for i, dev, lo, hi in self._row_tiles(L):
            tot = self._put(totals32, dev, lo, hi)
            lat_d, viol_d, lsum_d, vt_d = self._draw(
                "fused", ch, i, lo, hi, L,
                scale=self._put(scale32, dev, lo, hi),
                slo=self._slo(i, lo, hi), totals=tot)
            valid = torch.arange(L, device=dev)[None, :] < tot[:, None]
            flat_parts.append(lat_d[valid].cpu().numpy())
            vflat_parts.append(viol_d[valid].cpu().numpy())
            lat_sums[lo:hi] = lsum_d.cpu().numpy()
            viol_t[lo:hi] = vt_d.cpu().numpy()
        return (np.concatenate(flat_parts), np.concatenate(vflat_parts),
                lat_sums[:T], viol_t[:T])

    def _step_varying(self, ch, totals, starts, scale, counts, slo_rep, L,
                      T):
        """Time-varying scale matrix (bursty game fleets): the kernel
        draws dense jitter; the per-request scale product and reductions
        run numpy-side on the flat request axis."""
        parts = []
        for i, dev, lo, hi in self._row_tiles(L):
            jit_d = self._draw("jitter", ch, i, lo, hi, L)
            valid = (torch.arange(L, device=dev)[None, :]
                     < self._put(totals, dev, lo, hi)[:, None])
            parts.append(jit_d[valid].cpu().numpy())
        flat_jit = np.concatenate(parts)
        per_req = np.repeat(scale.ravel().astype(np.float32),
                            counts.ravel())
        flat_lat = per_req * flat_jit
        vflat = flat_lat > slo_rep
        csum = np.zeros(flat_lat.size + 1, np.float64)
        np.cumsum(flat_lat, dtype=np.float64, out=csum[1:])
        lat_sums = csum[starts[1:]] - csum[starts[:-1]]
        viol_t = np.zeros(T, np.int64)
        if vflat.any():
            np.add.reduceat(vflat.astype(np.int64), starts[:-1],
                            out=viol_t)
            viol_t[totals == 0] = 0
        return flat_lat, vflat, lat_sums, viol_t


class TorchBackend(EngineBackend):
    name = "torch"
    contract = "tolerance"
    rng_scheme = "counter-threefry"
    when_to_use = "mega-scale fleets (10^5+); hand-written GPU kernels"

    def tenant_rng(self, seed: int, name: str) -> tuple:
        # streams are derived from (seed, crc32(name), chunk, kind) at
        # draw time — there is no stateful generator to carry around
        return (None, None)

    def validate_scenario(self, scenario) -> None:
        # fail before any node is built when the device is not there
        fleet.check_device(scenario.backend_options.get("device", "cuda"))

    def make_stepper(self, nodes: list):
        return TorchFleetStepper(nodes)


TORCH_BACKEND = TorchBackend()
