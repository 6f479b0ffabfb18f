"""DYVERSE domain types (paper §2, Table 1)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class PricingModel(enum.Enum):
    """§3 pay-for-X models: Pay-For-Resources, Pay-For-Period, Hybrid."""

    PFR = "pfr"
    PFP = "pfp"
    HYBRID = "hybrid"


class Decision(enum.Enum):
    SCALE_UP = "scaleup"
    SCALE_DOWN = "scaledown"
    NONE = "none"
    TERMINATE = "terminate"


@dataclass(frozen=True)
class Weights:
    """Eq. 2–6 weights. The paper sets all equal to 1 (§5 Setup); varied
    weights are its stated future work — kept configurable here."""

    W_P: float = 1.0
    W_ID: float = 1.0
    W_Age: float = 1.0
    W_Loyalty: float = 1.0
    W_Request: float = 1.0
    W_U: float = 1.0
    W_Data: float = 1.0
    W_Reward: float = 1.0
    W_Scale: float = 1.0


@dataclass(frozen=True)
class ResourceUnit:
    """uR — one unit of resources. Paper: one unit of CPU+memory; here:
    decode batch slots + KV pages (the accelerator's contended resources)."""

    slots: int = 1
    pages: int = 8


@dataclass(slots=True)
class Quota:
    """R_s — resources currently allocated to a tenant."""

    slots: int
    pages: int

    def add_units(self, n: int, uR: ResourceUnit) -> "Quota":
        return Quota(self.slots + n * uR.slots, self.pages + n * uR.pages)

    def sub_units(self, n: int, uR: ResourceUnit) -> "Quota":
        return Quota(max(self.slots - n * uR.slots, 0),
                     max(self.pages - n * uR.pages, 0))

    def units(self, uR: ResourceUnit) -> int:
        """R_s measured in uR units (min over dimensions, conservatively)."""
        return min(self.slots // max(uR.slots, 1), self.pages // max(uR.pages, 1))

    def copy(self) -> "Quota":
        return Quota(self.slots, self.pages)


@dataclass(frozen=True)
class TenantSpec:
    """What the Cloud Manager provides when offloading a server (§2)."""

    name: str
    slo_latency: float                  # L_s (seconds)
    users: int = 1                      # |U_s|
    donation: bool = False              # donation_s
    down_threshold: float = 0.8         # dThr_s
    premium: float = 0.0                # P_s — price paid for priority
    pricing: PricingModel = PricingModel.HYBRID
    arch: str = "tinyllama-1.1b"        # model this tenant serves
    min_units: int = 1                  # floor below which we terminate instead
    # ceiling the actuator can actually enforce (None → unbounded). The
    # serving engine sets this to its compiled decode-batch cap so the
    # controller never bills NodeCapacity for slots the scheduler would
    # clamp away — Eq. 1 utilisation always equals the enforced quota.
    max_units: int | None = None


@dataclass
class TenantState:
    """Edge-Manager registry entry for a running tenant."""

    spec: TenantSpec
    ordinal: int                        # ID_s — launch sequence number
    quota: Quota
    active: bool = True
    age: int = 0                        # Age_s — times rejected by the node
    loyalty: int = 0                    # Loyalty_s — times service was used
    scale_count: int = 0                # Scale_s — penalised scalings
    reward_count: int = 0               # Reward_s — donations made
    priority: float = 0.0               # last computed PS
    last_vr: float = 0.0                # VR_s from previous round


@dataclass(slots=True)
class RoundAction:
    tenant: str
    decision: Decision
    units: int = 0
    priority: float = 0.0
    terminated_for: str | None = None   # set when evicted to free resources


@dataclass(slots=True)
class RoundReport:
    """One dynamic-vertical-scaling round (Procedure 1)."""

    policy: str
    actions: list[RoundAction] = field(default_factory=list)
    priority_update_s: float = 0.0      # overhead: priority management
    scaling_s: float = 0.0              # overhead: scaling mechanism
    forecast_s: float = 0.0             # overhead: forecast prediction
    #                                     (proactive/hybrid scaling only)
    terminated: list[str] = field(default_factory=list)
    # full round-pipeline walls (forecast/priority/classification/
    # eviction/actuation/scaling), populated only while a
    # repro_torch.obs.FlightRecorder observes the run; None when tracing is off
    phases: dict[str, float] | None = None
