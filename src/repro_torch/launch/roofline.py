"""Roofline analysis of dry-run cells (port of ``repro/launch/roofline.py``)
on NVIDIA H100 constants.

Per (arch, cell, mesh):

    compute    = device_flops            / peak_flops        [s]
    memory     = device_hbm_bytes        / hbm_bw            [s]
    collective = device_link_bytes       / link_bw           [s]

with the per-device numbers of ``launch/op_analysis.py`` (an
:class:`~repro_torch.launch.op_analysis.OpCost` of one run of the step;
``FlopCounterMode``'s total over the same run is recorded beside them as
``raw_flops``, the library's own count).  The dominant term is the
bottleneck; the compute term's share of the step-time lower bound (the
largest term) is the roofline fraction.  MODEL_FLOPS = 6 * N_active * D;
MODEL_FLOPS / (chips * device FLOPs) flags recomputation and redundancy.

:class:`HW`'s defaults are one H100 SXM5 80 GB's, from NVIDIA's H100
Tensor Core GPU datasheet (dense rates, without sparsity, at 700 W):

* ``peak_flops`` 989 TFLOP/s, bf16 on the tensor cores;
* ``peak_flops_int8`` 1979 TOPS, int8 on the tensor cores;
* ``hbm_bw`` 3.35 TB/s, HBM3;
* ``link_bw`` 50 GB/s a card each way: the slowest link a collective of
  the production mesh crosses.  NVLink joins the 8 cards of one node at
  450 GB/s each way (900 GB/s total), but every 'data' group of the
  16 x 16 mesh (stride 16) and every 'model' group of 16 spans more
  than one 8-card node, so their rings cross the inter-node network:
  one 400 Gb/s NDR InfiniBand adapter a card, 50 GB/s each way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.launch.op_analysis import OpCost

__all__ = ["HW", "RooflineReport", "roofline", "format_row"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12        # bf16 / card
    peak_flops_int8: float = 1979e12
    hbm_bw: float = 3.35e12           # bytes/s
    link_bw: float = 50e9             # bytes/s/card, inter-node


@dataclasses.dataclass
class RooflineReport:
    arch: str
    cell: str
    mesh: str
    chips: int
    # per-device costs
    device_flops: float
    device_bytes: float
    device_link_bytes: float
    per_collective: Dict[str, float]
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float               # MODEL_FLOPS / (chips * device_flops)
    # FlopCounterMode's total over the same run, for reference
    raw_flops: Optional[float] = None
    raw_bytes: Optional[float] = None
    memory_per_device: Optional[dict] = None
    int8: bool = False                # compute term used the int8 peak

    @property
    def step_time_lb(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the per-card compute roofline achieved at the
        step-time lower bound."""
        if self.step_time_lb == 0:
            return 0.0
        return self.t_compute / self.step_time_lb

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["step_time_lb"] = self.step_time_lb
        d["roofline_fraction"] = self.roofline_fraction
        return d


def roofline(arch: str, cell: str, mesh_name: str, chips: int,
             cost: OpCost, model_flops: float, hw: HW = HW(),
             int8: bool = False,
             memory_per_device: Optional[dict] = None) -> RooflineReport:
    peak = hw.peak_flops_int8 if int8 else hw.peak_flops
    t_c = cost.flops / peak
    t_m = cost.bytes / hw.hbm_bw
    t_l = cost.collective_bytes / hw.link_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / (chips * cost.flops) if cost.flops else 0.0
    return RooflineReport(
        arch=arch, cell=cell, mesh=mesh_name, chips=chips,
        device_flops=cost.flops, device_bytes=cost.bytes,
        device_link_bytes=cost.collective_bytes,
        per_collective=dict(cost.per_collective),
        t_compute=t_c, t_memory=t_m, t_collective=t_l,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=useful, raw_flops=cost.raw_flops, raw_bytes=None,
        memory_per_device=memory_per_device, int8=int8,
    )


def format_row(r: RooflineReport) -> str:
    return (f"{r.arch:22s} {r.cell:12s} {r.mesh:10s} "
            f"comp {r.t_compute*1e3:9.2f}ms mem {r.t_memory*1e3:9.2f}ms "
            f"coll {r.t_collective*1e3:9.2f}ms -> {r.bottleneck:10s} "
            f"useful {r.useful_ratio*100:5.1f}% "
            f"roofline_frac {r.roofline_fraction*100:5.1f}%")
