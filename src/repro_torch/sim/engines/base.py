"""Engine-backend protocol + registry: the single dispatch seam for
every execution engine the simulator stack knows about.

An :class:`EngineBackend` owns everything that used to live in inline
``cfg.engine == ...`` branches spread over ``edgesim.py`` /
``federation.py`` / ``scenario.py``:

* **chunk stepping** — either per-node (:meth:`EngineBackend.step_node`)
  or fleet-wide via a stepper object (:meth:`EngineBackend.make_stepper`
  returning something with a ``step(t0, t1)`` method);
* **RNG stream construction** — :meth:`EngineBackend.tenant_rng` builds
  whatever per-tenant random-stream state the engine consumes (numpy
  Generator pairs for the bitwise engines, nothing for the counter-based
  torch engine);
* **its equivalence contract** — ``contract`` declares whether the
  engine is bitwise-pinned to the scalar reference (``"bitwise"``),
  statistically equivalent within documented tolerances
  (``"tolerance"``), or a different system entirely (``"token-level"``,
  the serving engine);
* **the scenario seam** — validation, smoke-sizing (``quick``), the
  reported duration, and how a compiled federation config is actually
  run (:meth:`EngineBackend.run_federation`).

Engines register under their ``SimConfig.engine`` name via
:func:`register_engine`; heavyweight backends (torch) register a
:class:`LazyEntry` so importing :mod:`repro_torch.sim` never pays their
import cost. :func:`resolve_engine` is the one lookup everything else
dispatches through.
"""
from __future__ import annotations

import importlib
import zlib

import numpy as np


def tenant_stream(seed: int, name: str):
    """Per-tenant RNG substreams, stable across runs and processes
    (``hash()`` is salted per process, so key on crc32 instead).

    Two independent generators per tenant — one for arrival counts, one
    for latency jitter. Keeping the draw kinds on separate streams is
    what lets the scalar engine draw second-by-second and the vectorized
    engine draw chunk-by-chunk while realising the same values: numpy's
    Generator consumes its bitstream identically for one size-N draw and
    for N sequential draws, as long as no other draw kind interleaves."""
    key = zlib.crc32(name.encode())
    return (np.random.default_rng((seed, key, 0)),
            np.random.default_rng((seed, key, 1)))


class EngineBackend:
    """One execution engine. Subclasses override the hooks they own;
    the defaults implement the common per-node / numpy-substream /
    plain-federation behaviour so small backends stay small."""

    #: ``SimConfig.engine`` registry name.
    name: str = ""
    #: equivalence contract vs the scalar reference engine:
    #: "bitwise" | "tolerance" | "token-level".
    contract: str = "bitwise"
    #: how per-tenant randomness is produced.
    rng_scheme: str = "numpy-substream"
    #: True when the engine can drive an :class:`EdgeNodeSim` chunk
    #: (False → federation-owned engines like "serving").
    node_capable: bool = True
    #: one-line guidance for the engine matrix docs.
    when_to_use: str = ""

    # ------------------------------------------------------------- RNG
    def tenant_rng(self, seed: int, name: str) -> tuple:
        """Per-tenant random-stream state carried in
        ``EdgeNodeSim.tenant_rngs`` (and across nodes on migration)."""
        return tenant_stream(seed, name)

    # -------------------------------------------------------- stepping
    def make_stepper(self, nodes: list):
        """A fleet-wide stepper (``step(t0, t1)``) advancing ``nodes``
        in lockstep, or None when the engine steps nodes one at a
        time (→ :meth:`step_node`)."""
        return None

    def step_node(self, node, t0: int, t1: int) -> None:
        """Advance one node's chunk. The default lazily builds (and
        caches on the node) a single-node stepper from
        :meth:`make_stepper` — per-node engines override this
        directly instead."""
        if node._stepper is None:
            node._stepper = self.make_stepper([node])
            if node._stepper is None:
                raise NotImplementedError(
                    f"engine {self.name!r} implements neither step_node "
                    f"nor make_stepper")
        node._stepper.step(t0, t1)

    # ---------------------------------------------------- scenario seam
    def validate_scenario(self, scenario) -> None:
        """Engine-specific :class:`~repro_torch.sim.scenario.Scenario` checks
        (beyond the engine-agnostic ones ``Scenario.validate`` runs)."""

    def scenario_duration(self, scenario) -> float:
        """The session length a scenario reports/tabulates."""
        return scenario.duration_s

    def quick_scenario(self, scenario, round_interval: int, rounds: int):
        """The smoke-sized variant of a scenario (CI / --quick)."""
        return scenario._quick_rescale(round_interval, rounds)

    def run_federation(self, fleet, cfg, scenario=None):
        """Run one compiled federation config over a built fleet and
        return a :class:`~repro_torch.sim.federation.FederationResult`."""
        from repro_torch.sim.federation import EdgeFederation

        return EdgeFederation(fleet, cfg).run()


class LazyEntry:
    """Registry placeholder for a backend whose module is expensive to
    import (torch and its kernels): carries the registry metadata so
    listings and the engine matrix never trigger the import;
    :func:`resolve_engine` swaps in the real backend on first use."""

    def __init__(self, name: str, module: str, attr: str, *,
                 contract: str, rng_scheme: str, node_capable: bool = True,
                 when_to_use: str = ""):
        self.name = name
        self.module = module
        self.attr = attr
        self.contract = contract
        self.rng_scheme = rng_scheme
        self.node_capable = node_capable
        self.when_to_use = when_to_use

    def load(self) -> EngineBackend:
        backend = getattr(importlib.import_module(self.module), self.attr)
        for f in ("name", "contract", "rng_scheme", "node_capable"):
            if getattr(backend, f) != getattr(self, f):
                raise RuntimeError(
                    f"lazy registration of {self.name!r} disagrees with "
                    f"the backend on {f!r}")
        return backend


ENGINE_BACKENDS: dict[str, "EngineBackend | LazyEntry"] = {}


def register_engine(backend: "EngineBackend | LazyEntry"):
    """Register under ``backend.name`` (last registration wins)."""
    if not backend.name:
        raise ValueError("engine backend needs a name")
    ENGINE_BACKENDS[backend.name] = backend
    return backend


def resolve_engine(engine: "str | EngineBackend") -> EngineBackend:
    """The one lookup every dispatch site goes through. Accepts a
    registry name or a backend instance (pass-through)."""
    if isinstance(engine, EngineBackend):
        return engine
    entry = ENGINE_BACKENDS.get(engine)
    if entry is None:
        raise ValueError(
            f"engine {engine!r} not in {tuple(ENGINE_BACKENDS)}")
    if isinstance(entry, LazyEntry):
        entry = register_engine(entry.load())
    return entry


def engine_names() -> tuple[str, ...]:
    """Every registered engine, registration order."""
    return tuple(ENGINE_BACKENDS)


def sim_engines() -> tuple[str, ...]:
    """The node-capable engines — the valid ``SimConfig.engine`` values
    (the ``ENGINES`` compat constant in :mod:`repro_torch.sim.edgesim`)."""
    return tuple(name for name, b in ENGINE_BACKENDS.items()
                 if b.node_capable)


def engine_matrix() -> str:
    """The engine × contract × RNG-scheme × when-to-use table (rendered
    into the :mod:`repro_torch.sim` docs; pinned by tests against the
    registry so the docs can't drift)."""
    rows = [(b.name, b.contract, b.rng_scheme, b.when_to_use)
            for b in ENGINE_BACKENDS.values()]
    widths = [max(len(r[i]) for r in rows + [_MATRIX_HDR])
              for i in range(3)]
    lines = []
    for r in [_MATRIX_HDR] + rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths))
                     + "  " + r[3])
    return "\n".join(lines)


_MATRIX_HDR = ("engine", "contract", "rng scheme", "when to use")
