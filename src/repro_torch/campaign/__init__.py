"""``repro_torch.campaign``: the auto-evaluation campaign harness (the
port of the reference's ``repro.campaign``, numpy on the host).

Georgiou et al. auto-generate multi-tenancy evaluation campaigns
instead of hand-wiring each experiment; this package does the same for
the DYVERSE reproduction — it turns the declarative
:data:`repro_torch.sim.scenario.SCENARIOS` registry into an instrument that
*runs a sweep, aggregates it, and flags regressions* with one command::

    PYTHONPATH=src python -m repro_torch.benchmarks.campaign --quick \
        --device cpu

Spec grammar
============

A campaign is a :class:`~repro_torch.campaign.spec.CampaignSpec`::

    CampaignSpec(
        name="ci",
        grids=(SweepGrid(
            scenarios=("*",),                 # names | "*" | Scenario
            engines=("vectorized", "batched", "torch", "serving"),
            control_planes=(),                # () = inherit scenario's
            placements=(),
            policies=("none", "sdps"),        # priority policies
            scaling_policies=("reactive", "proactive"),
            forecasters=(),
            seeds=(),
            backend_options=((),),            # ((("scale_kernel", True),),)
        ),),
        include=(),                           # ({"engine": "torch"},) …
        exclude=(),
        cell_timeout_s=900.0,
    )

Each :class:`~repro_torch.campaign.spec.SweepGrid` is one rectangular sweep;
the EMPTY tuple on an axis means "inherit the scenario's own values".
:func:`~repro_torch.campaign.spec.expand_campaign` lowers the spec
deterministically into ordered :class:`~repro_torch.campaign.spec.RunSpec`
cells — applying per-axis validity masking (serving scenarios pair
exclusively with the serving engine, the ``scale_kernel`` backend
option is torch-only, ``device`` torch/serving-only, ``jit_scale``
batched-only, the forecaster axis
is inert under reactive scaling, the scaling axis inert under the
``none`` policy), then include/exclude filters, then first-wins
de-duplication. One cell = one (scenario × engine × control_plane ×
placement × policy × scaling_policy × forecaster × seed × options)
point; the seed is an axis, so per-cell seeding is deterministic by
construction.

Execution and reporting
=======================

:func:`~repro_torch.campaign.executor.run_cells` fans cells out across
worker processes (one child per cell from a fork server — never a fork
of the caller, which may hold a CUDA context — per-cell timeout, crash
and exception capture as structured ``status`` records — one failing
cell never kills the campaign). :class:`~repro_torch.campaign.report.
CampaignReport` rolls the records up: grouped tables, per-axis VR
marginals, token-level latency bands next to the model-based band
fractions, cross-engine/-control-plane consistency checks, and a
byte-stable ``canonical_json()`` (wall clocks, measured overheads and
host fingerprints stripped — same spec + same code ⇒ identical bytes).
The report persists as ``BENCH_torchcampaign.json`` through the shared
:mod:`~repro_torch.campaign.benchio` schema (``schema_version`` 1; the
tolerant loader degrades missing/older files to "no baseline").

Regression gate
===============

:func:`~repro_torch.campaign.diff.diff_report` compares the report against
the previous ``BENCH_torchcampaign.json`` and the per-section
``BENCH_torch{scenarios,forecast,resilience,serving}.json``
trajectories.
Default :class:`~repro_torch.campaign.diff.Tolerances`:

* ``vr_pp = 0.5`` — a cell's violation rate may grow at most 0.5
  percentage points over its baseline;
* ``wall_ratio = 1.75`` — a cell's wall clock may grow at most 1.75×,
  compared only when both runs are full-mode on the same ``cpu_model``
  and the same card (and the old wall ≥ ``wall_floor_s = 0.05`` s);
* VR *improvements* beyond tolerance are informational, never fatal.

The CLI gate (:mod:`repro_torch.benchmarks.campaign`) exits non-zero
on any failed/timed-out cell, non-finite VR, request-conservation
violation, consistency-contract disagreement, or regression beyond
tolerance.
"""
from repro_torch.campaign.benchio import (SCHEMA_VERSION,  # noqa: F401
                                          bench_path, bench_payload,
                                          load_bench, load_section,
                                          machine_info, write_bench)
from repro_torch.campaign.diff import (DiffResult, Tolerances,  # noqa: F401
                                       diff_report)
from repro_torch.campaign.executor import (artifact_dir_for,  # noqa: F401
                                           run_cell, run_cells)
from repro_torch.campaign.registry import (CAMPAIGNS,  # noqa: F401
                                           campaign_names, format_campaigns,
                                           get_campaign)
from repro_torch.campaign.report import (CampaignReport,  # noqa: F401
                                         build_report)
from repro_torch.campaign.spec import (CampaignSpec, RunSpec,  # noqa: F401
                                       SweepGrid, expand_campaign,
                                       expand_grid, mask_reason, on_device)
