"""Multi-tenant serving under DYVERSE quotas.

Exports resolve lazily so that the torch-free layers — the scenario API
imports :mod:`repro_torch.serving.spec` for its specs — never pay for
the engine's model code until a serving run needs it."""
from repro_torch.serving.request import Request, RequestState  # noqa: F401
from repro_torch.serving.scheduler import QuotaScheduler  # noqa: F401
from repro_torch.serving.spec import (ServingClassSpec,  # noqa: F401
                                      ServingSpec, VirtualClock)

_LAZY = {
    "EngineConfig": "repro_torch.serving.engine",
    "MultiTenantEngine": "repro_torch.serving.engine",
    "CLOUD_LATENCY_S": "repro_torch.serving.engine",
    "ServingFederation": "repro_torch.serving.federation",
    "ServingFederationResult": "repro_torch.serving.federation",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
