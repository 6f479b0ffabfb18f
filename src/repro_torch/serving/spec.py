"""Serving-federation specs and the virtual clock (engine-free, sim-free).

These types shape a serving scenario without importing either the
serving engine or the simulation layer, so the scenario API can build
:class:`ServingSpec` instances at import time. The serving engine and
its federation are not part of this package yet: a scenario with
``engine="serving"`` is rejected by the engine registry.
"""
from __future__ import annotations

from dataclasses import dataclass


class VirtualClock:
    """Deterministic time source shared by every engine in a federation:
    ``clock()`` reads the current virtual second, ``tick()`` advances it
    by one engine step. Injected as ``MultiTenantEngine(clock=...)``."""

    def __init__(self, step_dt: float):
        self.step_dt = step_dt
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.step_dt


@dataclass(frozen=True)
class ServingClassSpec:
    """Serving parameters for every tenant whose name starts with
    ``prefix`` (the fleet side — names, users, base latency — still
    comes from the scenario's :class:`FleetSpec`)."""

    prefix: str
    arch: str = "tinyllama-1.1b"        # reduced model the class serves
    rate: float = 0.5                   # mean requests per engine step
    prompt_len: int = 6
    max_new_tokens: int = 4
    slo_s: float | None = None          # None → slo_scale · base_latency

    def matches(self, tenant: str) -> bool:
        return tenant == self.prefix or tenant.startswith(self.prefix + "-")


@dataclass(frozen=True)
class ServingSpec:
    """Engine-side shape of a serving scenario. Virtual session length
    is ``rounds × steps_per_round × step_dt`` seconds; scaling rounds
    run at the interior boundaries, exactly like the sim federation."""

    classes: tuple[ServingClassSpec, ...]
    rounds: int = 4
    steps_per_round: int = 24
    step_dt: float = 0.25               # virtual seconds per engine step
    slot_cap: int = 4                   # compiled decode batch per tenant
    page_size: int = 4
    pages_per_unit: int = 4             # uR = (1 slot, pages_per_unit pages)
    max_seq_len: int = 64
    drain_steps: int = 512              # post-session in-flight completion cap
    vocab: int = 200                    # prompt tokens drawn from [1, vocab)
    # ---- resilience knobs (all off by default, so the pre-fault-model
    # pins stay bitwise-identical)
    # per-request timeout: a request not finished timeout_s after its
    # (re-)submission frees its decode slot/KV pages and re-enqueues
    # with capped exponential backoff, up to retry_limit times; after
    # that it falls back to the Cloud tier. None → never times out.
    timeout_s: float | None = None
    retry_limit: int = 2
    backoff_base_s: float = 0.5         # backoff = base · 2^(retry-1) …
    backoff_cap_s: float = 4.0          # … capped here (virtual seconds)
    # graceful load shedding: when a node's total admission-queue depth
    # exceeds shed_depth, the lowest-priority tenants' youngest waiting
    # requests are shed — counted as SLO violations, never silently
    # dropped. None → queue unboundedly.
    shed_depth: int | None = None

    @property
    def round_virtual_s(self) -> float:
        return self.steps_per_round * self.step_dt

    @property
    def duration_virtual_s(self) -> float:
        return self.rounds * self.round_virtual_s

    def class_for(self, tenant: str) -> ServingClassSpec:
        for c in self.classes:
            if c.matches(tenant):
                return c
        raise ValueError(f"no ServingClassSpec prefix matches tenant "
                         f"{tenant!r} (have {[c.prefix for c in self.classes]})")
