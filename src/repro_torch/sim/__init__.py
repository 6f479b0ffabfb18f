"""Simulator stack: workloads, nodes, federation, scenarios.

Execution engines (``SimConfig.engine`` / ``Scenario.engine``) dispatch
through the :mod:`repro_torch.sim.engines` registry. The matrix (rendered
live by :func:`repro_torch.sim.engines.engine_matrix`, pinned by tests):

========== =========== =============== =============================
engine     contract    rng scheme      when to use
========== =========== =============== =============================
scalar     bitwise     numpy-substream reference semantics; tiny
                                       fleets, debugging
vectorized bitwise     numpy-substream default; O(1) numpy calls per
                                       tenant per chunk
batched    bitwise     numpy-substream large fleets (10^2-10^4
                                       tenants); one stacked matrix
                                       per chunk
torch      tolerance   counter-        mega-scale fleets (10^5+);
                       threefry        hand-written GPU kernels
========== =========== =============== =============================

* **bitwise** — the three numpy engines realise the identical random
  trace from per-tenant Generator substreams and evaluate identical
  float64 expressions, so every downstream number is bitwise equal.
* **tolerance** — the torch engine draws the same distributions from
  counter-based threefry streams in float32 (on the GPU through the
  kernels of :mod:`repro_torch.kernels.fleet`); violation rates and
  latency summaries match the trio statistically, within tolerances
  pinned by tests/test_torch_engine.py (see
  :mod:`repro_torch.sim.engines.torch_backend` for exactly where and
  why bitwise breaks).

The serving engine (``engine="serving"``, a real multi-tenant LLM
engine under the same control plane) is not ported yet: the registry
rejects it, so the two serving scenarios in ``SCENARIOS`` raise
``ValueError`` when run.

Fault-model support (``Scenario.faults`` / :class:`FaultSpec`): every
fault kind fires at a chunk boundary and is honoured by **all four**
engines and both control planes —

=============== ==================================== =================
fault           effect                               engines
=============== ==================================== =================
NodeFailure     node dies; live tenants fail over    all (scalar /
(+ recover_t)   to survivors or the Cloud; with      vectorized /
                ``recover_t`` the node rejoins and   batched / torch)
                Cloud-fallback refugees are drained
                back onto the Edge by the placement
                policy (Age_s/Loyalty_s carried)
NodeDegradation capacity shrinks to                  all
                ``capacity_fraction`` for [t0, t1),
                forcing a Procedure-2/3 contraction
                cascade, then restores
WanFault        per-node WAN latency bump for        all
                [t0, t1) — threads through
                ``wan_extra_latency`` into every
                Cloud round-trip
=============== ==================================== =================

The numpy trio stays bitwise-identical through every fault path (no
fault draws new randomness).

Observability (``repro_torch.obs``)
===================================

``Scenario(trace=True)`` (or ``SimConfig.recorder`` /
``FederationConfig.recorder`` directly) attaches a
:class:`repro_torch.obs.FlightRecorder` — a bounded ring of typed structured
events stamped with the virtual clock, round index, node, tenant and
cause. Tracing is strictly observational: it draws no RNG and perturbs
no control decision, so every bitwise pin above holds with tracing on;
with tracing off the hot loops pay one ``is None`` predicate.

Event vocabulary (pinned by tests/test_obs.py): ``placement``,
``scale_up`` / ``scale_down`` / ``donation`` / ``terminate``
(Procedures 1–3), ``node_fail`` / ``node_recover`` / ``node_degrade``
/ ``node_restore`` / ``wan_fault`` (fault model), ``serving_admit`` /
``serving_preempt`` / ``serving_retry`` / ``serving_timeout`` /
``serving_shed`` / ``serving_cloud`` (serving control loop), and the
``round`` / ``chunk`` spans. Traced runs also profile the FULL round
pipeline per round — monitor_feed / forecast / priority /
classification / eviction / actuation / scaling — in
``SimResult.overhead_phases`` (extending the three coarse overhead
lists).

Exporters: ``result.write_events_jsonl(path)`` (one JSON per line) and
``result.write_trace(path)`` on ``SimResult`` / ``FederationResult`` /
``ScenarioResult`` — the latter writes Chrome-trace JSON (rounds and
chunks as slices, everything else as instants, one track per node,
one process group per policy key); load it at https://ui.perfetto.dev
or ``chrome://tracing``.
"""
from repro_torch.sim.workload import (FleetBatch, GameWorkload,  # noqa: F401
                                      StreamWorkload, Workload, make_game_fleet,
                                      make_stream_fleet)
from repro_torch.sim.engines import (ENGINE_BACKENDS, EngineBackend,  # noqa: F401
                                     engine_matrix, engine_names,
                                     register_engine, resolve_engine,
                                     sim_engines)
from repro_torch.sim.edgesim import (ENGINES, EdgeNodeSim,  # noqa: F401
                                     FleetStepper, SimConfig, SimResult,
                                     tenant_stream)
from repro_torch.sim.federation import (PLACEMENTS, SWEEP_POLICIES,  # noqa: F401
                                        EdgeFederation, FederationConfig,
                                        FederationResult, PlacementEvent,
                                        PlacementPolicy, paper_capacity_units,
                                        resolve_placement)
from repro_torch.sim.scenario import (SCENARIOS, FaultSpec, FleetSpec,  # noqa: F401
                                      NodeDegradation, NodeFailure,
                                      PolicyOutcome, Scenario, ScenarioResult,
                                      TenantClassSpec, TopologySpec, WanFault,
                                      register_scenario, run_scenario)
from repro_torch.core.forecast import (FORECASTERS,  # noqa: F401  (re-export)
                                 SCALING_POLICIES)
