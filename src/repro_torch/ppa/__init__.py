"""PPA planner (port of ``repro/ppa``): invert the calibrated hardware
model into decisions.

``ppa.model`` extends the Table I-III calibrated :class:`CostModel`
across the encoding zoo (per-spec plane-schedule algebra -> predicted
cycles / latency / energy / area per (encoding, T, dataflow, units));
``ppa.search`` enumerates the legal (encoding, T, dataflow, units)
lattice and picks a configuration under accuracy / latency / energy
constraints.  Every modeled number is the paper's FPGA build, never a
measure of the GPU.
"""

from repro_torch.ppa.model import (
    EncodingCostModel,
    PPAReport,
    hw_arch_from_qnet,
    layers_from_qnet,
    modeled_matmul_energy_uj,
    stats_provider,
)
from repro_torch.ppa.search import AutoPlan, Candidate, autoconfigure

__all__ = [
    "EncodingCostModel",
    "PPAReport",
    "hw_arch_from_qnet",
    "layers_from_qnet",
    "modeled_matmul_energy_uj",
    "stats_provider",
    "AutoPlan",
    "Candidate",
    "autoconfigure",
]
