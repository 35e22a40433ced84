"""Runtime fault tolerance (port of ``repro/runtime``): stragglers,
checkpoint/restart (``RestartableRun``), elastic re-sharding
(``elastic``) and serving resilience (admission, deadlines, quarantine,
chaos)."""

from repro_torch.runtime.restart import FaultInjected, RestartableRun
from repro_torch.runtime.straggler import MitigationPolicy, StragglerMonitor
from repro_torch.runtime.resilience import (
    AdmissionError,
    ChaosServer,
    DeadlineExceeded,
    FaultPlan,
    HealthMonitor,
    RequestPoisoned,
    ResilienceStats,
    RetryPolicy,
    ServeError,
)

__all__ = [
    "FaultInjected",
    "RestartableRun",
    "StragglerMonitor",
    "MitigationPolicy",
    "ServeError",
    "AdmissionError",
    "DeadlineExceeded",
    "RequestPoisoned",
    "RetryPolicy",
    "ResilienceStats",
    "HealthMonitor",
    "FaultPlan",
    "ChaosServer",
]
