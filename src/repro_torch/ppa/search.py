"""Auto-configuration (port of ``repro/ppa/search.py``): search the
(encoding, T, dataflow, units) lattice.

``autoconfigure`` inverts the calibrated hardware model: instead of the
user hand-picking an encoding, time-step count, dataflow and unit count
from the zoo, the planner enumerates every *legal* configuration the
``SPECS`` registry declares for the net, evaluates each spec's accuracy
once on a calibration batch (through the existing ``oracle`` reference
path — the same integer algebra every compiled plan is bit-exact
against), prices every (spec, dataflow, units) point with
:class:`~repro_torch.ppa.model.EncodingCostModel`, filters by the caller's
constraints, and returns the Pareto frontier plus a picked winner —
with a rejection reason recorded for every pruned candidate, so "why
not rate coding?" always has an answer.

The lattice is level-matched per bit width ``K``: radix(K), ttfs(K),
rate(2^K - 1 steps) and phase(2K steps, 2 periods) all represent
``2^K`` levels (rate: ``2^K`` counts), so candidates differ in temporal
schedule and hardware cost, not quantization granularity.

Accuracy without labels is *fidelity*: argmax agreement between the
quantized forward and the float reference on the calibration batch
(pass ``labels=`` to score against ground truth instead).  It is
evaluated once per spec and shared across that spec's (dataflow, units)
candidates — dataflow and unit count never change the computed logits,
only the modeled PPA.

The search runs on a device (``device=``, the CUDA device unless the
caller passes ``"cpu"``): every candidate spec is converted there and
scored by the packed oracle there, whose logits are integers times a
scale, so a plan found on the card is the plan found on the CPU wherever
the float calibration agrees.  The modeled PPA is the paper's FPGA build
(``core/hwmodel``), never a measure of the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import conversion, hwmodel
from repro_torch.core.encoding import (
    EncodingSpec,
    PhaseEncoding,
    RadixEncoding,
    RateEncoding,
    TTFSEncoding,
)
from repro_torch.ppa.model import (
    EncodingCostModel,
    PPAReport,
    layers_from_qnet,
)

__all__ = ["Candidate", "AutoPlan", "autoconfigure"]


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the searched lattice, with its fate.

    ``rejected`` is the provenance: empty for feasible candidates, else
    every constraint (or legality) reason that pruned it.  Spec-level
    rejections (e.g. an illegal pool mode) carry ``units=0`` and no PPA
    report — the point was never priced.
    """

    spec: EncodingSpec
    backend: str
    dataflow: Optional[str]
    units: int
    accuracy: Optional[float] = None
    ppa: Optional[PPAReport] = None
    rejected: Tuple[str, ...] = ()

    @property
    def feasible(self) -> bool:
        return not self.rejected

    @property
    def label(self) -> str:
        how = self.dataflow if self.dataflow is not None else self.backend
        return (f"{self.spec.name}/T={self.spec.num_steps}/{how}"
                f"/units={self.units}")

    def to_dict(self) -> dict:
        return dict(
            label=self.label, encoding=self.spec.name,
            num_steps=self.spec.num_steps, backend=self.backend,
            dataflow=self.dataflow, units=self.units,
            accuracy=self.accuracy,
            ppa=self.ppa.to_dict() if self.ppa is not None else None,
            rejected=list(self.rejected),
        )


@dataclasses.dataclass
class AutoPlan:
    """The search result: every candidate, the Pareto frontier among the
    feasible ones, and the picked winner (None when nothing satisfies
    the constraints — ``summary()`` then reads as a diagnosis)."""

    item_shape: Tuple[int, ...]
    accuracy_floor: float
    latency_slo_us: Optional[float]
    energy_budget_uj: Optional[float]
    objective: str
    candidates: List[Candidate]
    frontier: List[Candidate]
    winner: Optional[Candidate]
    accuracy_evals: int
    calib_size: int
    _net: tuple = dataclasses.field(repr=False, compare=False, default=None)
    _qnets: dict = dataclasses.field(
        repr=False, compare=False, default_factory=dict)
    _device: Optional[torch.device] = dataclasses.field(
        repr=False, compare=False, default=None)

    def compile(self, *, parallel: Optional[int] = None,
                buckets: Optional[Sequence[int]] = None,
                autotune: bool = False,
                candidate: Optional[Candidate] = None):
        """Compile the winner (or ``candidate``, any priced one of
        ``candidates``) into an :class:`~repro_torch.api.Executable` on the search's
        device (same knobs as ``Accelerator.compile``).  Raises
        ``ValueError`` when no candidate is given and the search found no
        feasible configuration."""
        if candidate is None:
            if self.winner is None:
                raise ValueError(
                    "autoconfigure found no feasible configuration:\n"
                    + self.summary())
            candidate = self.winner
        elif candidate.ppa is None or candidate not in self.candidates:
            raise ValueError(
                f"candidate {candidate.label} is not a priced candidate of "
                "this plan")
        from repro_torch import api

        qnet = self._qnets[candidate.spec]
        acc = api.Accelerator(
            backend=candidate.backend,
            dataflow=(candidate.dataflow
                      if candidate.backend == "kernels" else None),
            device=self._device)
        return acc.compile(qnet, self.item_shape, parallel=parallel,
                           buckets=buckets, autotune=autotune)

    def summary(self) -> str:
        """Human-readable search report: constraints, winner, frontier,
        and one line of rejection provenance per pruned candidate."""
        n_feas = sum(1 for c in self.candidates if c.feasible)
        lines = [
            f"autoconfigure: {len(self.candidates)} candidates, "
            f"{n_feas} feasible, frontier {len(self.frontier)}, "
            f"objective {self.objective}",
            f"  constraints: accuracy >= {self.accuracy_floor:.3f}"
            + (f", latency <= {self.latency_slo_us:.1f}us"
               if self.latency_slo_us is not None else "")
            + (f", energy <= {self.energy_budget_uj:.1f}uJ"
               if self.energy_budget_uj is not None else ""),
        ]
        if self.winner is not None:
            w = self.winner
            lines.append(
                f"  winner: {w.label} — accuracy {w.accuracy:.3f}, "
                f"latency {w.ppa.latency_us:.1f}us, "
                f"energy {w.ppa.energy_uj:.1f}uJ, "
                f"area {w.ppa.klut:.1f}kLUT")
        else:
            lines.append("  winner: none (all candidates rejected)")
        for c in self.frontier:
            if self.winner is not None and c is self.winner:
                continue
            lines.append(
                f"  frontier: {c.label} — accuracy {c.accuracy:.3f}, "
                f"latency {c.ppa.latency_us:.1f}us, "
                f"energy {c.ppa.energy_uj:.1f}uJ, "
                f"area {c.ppa.klut:.1f}kLUT")
        for c in self.candidates:
            if not c.feasible:
                lines.append(f"  rejected {c.label}: "
                             + "; ".join(c.rejected))
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return dict(
            item_shape=list(self.item_shape),
            accuracy_floor=self.accuracy_floor,
            latency_slo_us=self.latency_slo_us,
            energy_budget_uj=self.energy_budget_uj,
            objective=self.objective,
            n_candidates=len(self.candidates),
            n_feasible=sum(1 for c in self.candidates if c.feasible),
            accuracy_evals=self.accuracy_evals,
            calib_size=self.calib_size,
            winner=(self.winner.to_dict()
                    if self.winner is not None else None),
            frontier=[c.to_dict() for c in self.frontier],
            rejected=[c.to_dict() for c in self.candidates
                      if not c.feasible],
        )


def _lattice(t_range: Sequence[int]) -> List[EncodingSpec]:
    """Level-matched specs per bit width K (see module docstring)."""
    specs: List[EncodingSpec] = []
    for k in t_range:
        specs.append(RadixEncoding(k))
        specs.append(TTFSEncoding(k))
        specs.append(RateEncoding((1 << k) - 1))
        if k >= 2:
            specs.append(PhaseEncoding(2 * k, periods=2))
    return specs


def _dominates(a: Candidate, b: Candidate) -> bool:
    """Pareto dominance: no worse on latency/energy/area/accuracy and
    strictly better on at least one."""
    le = (a.ppa.latency_us <= b.ppa.latency_us
          and a.ppa.energy_uj <= b.ppa.energy_uj
          and a.ppa.klut <= b.ppa.klut
          and a.accuracy >= b.accuracy)
    lt = (a.ppa.latency_us < b.ppa.latency_us
          or a.ppa.energy_uj < b.ppa.energy_uj
          or a.ppa.klut < b.ppa.klut
          or a.accuracy > b.accuracy)
    return le and lt


_OBJECTIVES = {
    "energy": lambda c: (c.ppa.energy_uj, c.ppa.latency_us, c.ppa.klut),
    "latency": lambda c: (c.ppa.latency_us, c.ppa.energy_uj, c.ppa.klut),
}


def _spikes_per_act(spec: EncodingSpec, calib: torch.Tensor) -> float:
    """Measured mean spikes per activation of the encoded calibration
    batch — the occupancy input for bit-serial pricing (an integer count
    over an integer size, so the same on every device)."""
    scale = float(max(float(calib.max()), 1e-9))
    planes = spec.encode(spec.quantize(calib, scale))
    return float(np.float64(int(planes.sum(dtype=torch.int64)))
                 / planes[0].numel())


def autoconfigure(
    net,
    item_shape: Sequence[int],
    *,
    calib,
    accuracy_floor: float,
    latency_slo_us: Optional[float] = None,
    energy_budget_uj: Optional[float] = None,
    labels=None,
    t_range: Sequence[int] = (3, 4, 5, 6),
    units: Sequence[int] = (1, 2, 4, 8),
    freq_mhz: float = 100.0,
    objective: str = "energy",
    weight_bits: int = 3,
    cfg_base: Optional[hwmodel.HwConfig] = None,
    cost_model: Optional[EncodingCostModel] = None,
    device=None,
) -> AutoPlan:
    """Search the legal (encoding, T, dataflow, units) lattice for
    ``net`` under PPA constraints.

    Args:
        net: the float ``(static, params)`` pair (conversion format) —
            the search re-quantizes it once per candidate spec.
        item_shape: per-item input shape, ``(H, W, C)`` for image nets.
        calib: calibration batch, ``(n,) + item_shape`` floats — used
            both for scale calibration and for the accuracy evaluation.
        accuracy_floor: minimum accuracy (label accuracy with
            ``labels=``, else argmax fidelity vs the float reference).
        latency_slo_us: optional modeled per-image latency ceiling.
        energy_budget_uj: optional modeled per-image energy ceiling.
        labels: optional ``(n,)`` int labels for the calibration batch.
        t_range: bit widths ``K`` to search (radix/ttfs T = K; rate
            ``2^K - 1`` steps; phase ``2K`` steps over 2 periods).
        units: convolution-unit counts to price.
        freq_mhz: modeled build clock.
        objective: ``"energy"`` (default) or ``"latency"`` — the axis
            the winner minimizes over the Pareto frontier.
        weight_bits: weight quantization passed through to ``convert``.
        cfg_base: hardware-geometry template (default ``HwConfig()``);
            ``n_conv_units`` / ``freq_mhz`` are overridden per candidate.
        cost_model: the pricing model (default calibrated).
        device: where the candidates are converted and scored (``None``:
            the CUDA device, which must exist; ``"cpu"``: the kernels'
            plain versions); ``plan.compile()`` compiles there too.

    Returns:
        An :class:`AutoPlan`; ``plan.winner`` is None when no candidate
        satisfies every constraint (``plan.compile()`` then raises with
        the full rejection provenance).

    Raises:
        TypeError: ``net`` is not a ``(static, params)`` pair (a
            ``QuantizedNet`` is already folded for one spec and cannot
            be re-encoded — pass the float net).
        ValueError: empty lattice axes, unknown objective, or a
            calibration batch whose item shape mismatches.
    """
    if isinstance(net, conversion.QuantizedNet):
        raise TypeError(
            "autoconfigure searches across encodings and must "
            "re-quantize: pass the float (static, params) pair, not an "
            "already-converted QuantizedNet")
    try:
        static, params = net
    except (TypeError, ValueError):
        raise TypeError(
            f"net must be a (static, params) pair, got {type(net).__name__}")
    if objective not in _OBJECTIVES:
        raise ValueError(
            f"objective must be one of {sorted(_OBJECTIVES)}, "
            f"got {objective!r}")
    if not t_range or not units:
        raise ValueError("t_range and units must be non-empty")
    item = tuple(int(d) for d in item_shape)
    from repro_torch import api

    dev = api._resolve_device(device)
    calib = torch.as_tensor(calib, dtype=torch.float32).to(dev)
    if tuple(calib.shape[1:]) != item:
        raise ValueError(
            f"calib item shape {tuple(calib.shape[1:])} != {item}")
    params = [None if p is None else {k: torch.as_tensor(v).to(dev)
                                      for k, v in p.items()}
              for p in params]

    model = cost_model if cost_model is not None else EncodingCostModel()
    cfg_base = cfg_base if cfg_base is not None else hwmodel.HwConfig()
    if labels is not None:
        ref = np.asarray(labels).reshape(-1)
    else:
        with torch.no_grad():
            ref = np.argmax(conversion.float_forward(
                static, params, calib).cpu().numpy(), -1)

    candidates: List[Candidate] = []
    qnets: Dict[EncodingSpec, conversion.QuantizedNet] = {}
    accuracy_evals = 0
    scales = None          # calibrated once, on the first legal spec

    for spec in _lattice(t_range):
        try:
            spec.validate_static(static)
        except ValueError as e:
            candidates.append(Candidate(
                spec=spec, backend="-", dataflow=None, units=0,
                rejected=(f"illegal for this net: {e}",)))
            continue
        if scales is None:
            with torch.no_grad():
                scales = conversion.calibrate(static, params, calib)
        with torch.no_grad():
            qnet = conversion._fold(static, params, scales, spec,
                                    weight_bits, per_channel=False)
        qnets[spec] = qnet
        pred = np.argmax(
            api.oracle(qnet, calib, mode="packed").cpu().numpy(), -1)
        accuracy = float((pred == ref).mean())
        accuracy_evals += 1
        layers = layers_from_qnet(qnet, item)
        spikes = _spikes_per_act(spec, calib)

        if "kernels" in spec.backends:
            hows = [("kernels", df) for df in spec.kernel_dataflows]
        else:
            hows = [("jnp", None)]
        for backend, dataflow in hows:
            if backend == "kernels":
                try:
                    spec.validate_dataflow(dataflow)
                except ValueError as e:
                    candidates.append(Candidate(
                        spec=spec, backend=backend, dataflow=dataflow,
                        units=0, accuracy=accuracy,
                        rejected=(f"illegal dataflow: {e}",)))
                    continue
            for n_units in units:
                cfg = dataclasses.replace(
                    cfg_base, n_conv_units=int(n_units),
                    freq_mhz=float(freq_mhz))
                rep = model.network_report(
                    layers, spec, dataflow=dataflow, cfg=cfg,
                    spikes_per_act=(spikes if dataflow == "bitserial"
                                    else None))
                reasons = []
                if accuracy < accuracy_floor:
                    reasons.append(
                        f"accuracy {accuracy:.3f} < floor "
                        f"{accuracy_floor:.3f}")
                if (latency_slo_us is not None
                        and rep.latency_us > latency_slo_us):
                    reasons.append(
                        f"modeled latency {rep.latency_us:.1f}us > SLO "
                        f"{latency_slo_us:.1f}us")
                if (energy_budget_uj is not None
                        and rep.energy_uj > energy_budget_uj):
                    reasons.append(
                        f"modeled energy {rep.energy_uj:.1f}uJ > budget "
                        f"{energy_budget_uj:.1f}uJ")
                candidates.append(Candidate(
                    spec=spec, backend=backend, dataflow=dataflow,
                    units=int(n_units), accuracy=accuracy, ppa=rep,
                    rejected=tuple(reasons)))

    feasible = [c for c in candidates if c.feasible]
    frontier = [c for c in feasible
                if not any(_dominates(o, c) for o in feasible if o is not c)]
    winner = min(frontier, key=_OBJECTIVES[objective], default=None)
    return AutoPlan(
        item_shape=item, accuracy_floor=float(accuracy_floor),
        latency_slo_us=latency_slo_us, energy_budget_uj=energy_budget_uj,
        objective=objective, candidates=candidates, frontier=frontier,
        winner=winner, accuracy_evals=accuracy_evals,
        calib_size=int(calib.shape[0]), _net=(static, params),
        _qnets=qnets, _device=dev)
