"""DYVERSE core: the paper's contribution as a composable library."""
from repro_torch.core.controller import (CONTROL_PLANES, AdmissionResult,  # noqa: F401
                                         DyverseController, NullActuator)
from repro_torch.core.forecast import (FORECASTERS, SCALING_POLICIES,  # noqa: F401
                                       EwmaForecaster, ForecastEngine,
                                       Forecaster, ForecastFrame, HistoryWindow,
                                       LastValueForecaster, LinearTrendForecaster,
                                       RoundHistory, SeasonalNaiveForecaster,
                                       resolve_forecaster)
from repro_torch.core.monitor import (DictMonitor, Monitor, RoundMetrics,  # noqa: F401
                                      SlotTable)
from repro_torch.core.priority import (POLICIES, batch_scores,  # noqa: F401
                                       batch_scores_np, cdps, priority_score,
                                       sdps, sps, wdps)
from repro_torch.core.quota import NodeCapacity, PoolError, ResourcePool  # noqa: F401
from repro_torch.core.types import (Decision, PricingModel, Quota,  # noqa: F401
                                    ResourceUnit, RoundAction, RoundReport,
                                    TenantSpec, TenantState, Weights)
