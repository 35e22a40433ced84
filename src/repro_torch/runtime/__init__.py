"""Runtime fault tolerance (port of ``repro/runtime``): stragglers and
serving resilience (admission, deadlines, quarantine, chaos).  Elastic
re-sharding and ``RestartableRun`` wait for the training slice."""

from repro_torch.runtime.restart import FaultInjected
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
