"""Distribution (port of ``repro/parallel``): the sharding rules, their
DTensor placements, and ZeRO state sharding."""

from repro_torch.parallel.sharding import (batch_specs, cache_specs,
                                           opt_state_specs, param_specs,
                                           shardings)
from repro_torch.parallel.zero import zero_upgrade

__all__ = ["param_specs", "batch_specs", "cache_specs", "opt_state_specs",
           "shardings", "zero_upgrade"]
