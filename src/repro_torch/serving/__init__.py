"""Serving under DYVERSE quotas — only the scenario-facing specs so far.

:mod:`repro_torch.serving.spec` is what the scenario registry needs at
import time; the multi-tenant engine and its federation are not ported
yet."""
from repro_torch.serving.spec import (ServingClassSpec,  # noqa: F401
                                            ServingSpec, VirtualClock)
