"""Encoding-aware PPA model (port of ``repro/ppa/model.py``): the
calibrated CostModel, generalized.

Every number here is the paper's FPGA build, modeled (``core/hwmodel``):
the latencies, energies and areas are predictions for that build, never
measures of the GPU this package runs on.

``core/hwmodel.CostModel`` is calibrated on the paper's radix builds,
where one inference replays ``T`` spike planes through the adder array.
Every shipped encoding declares its plane schedule via
:meth:`EncodingSpec.kernel_schedule` (``packed_bits`` planes per period,
``periods`` periods), so the generalization is a single number — the
*effective step count* an (encoding, dataflow) pair costs per image:

===========  =====================  =======================================
dataflow     effective steps        rationale
===========  =====================  =======================================
fused        ``periods``            one packed pass per period's plane
                                    group (the fused-epilogue schedule
                                    consumes all ``packed_bits`` planes of
                                    a period at once)
bitserial    ``packed_bits *        one adder-array pass per plane —
             periods``              the paper's hardware; phase pays
                                    P periods x K phases = T
(None)       ``num_steps``          plane-by-plane replay of the full
                                    train (the jnp reference schedule);
                                    rate pays its full T-step train
===========  =====================  =======================================

Bit-serial passes are *occupancy-scaled* when a measured
``spikes_per_act`` is supplied (the sparsity prepass skips all-zero
planes, DESIGN.md §8): with ``s`` spikes per activation the expected
fraction of non-empty plane slots is at most ``min(1, s)``, so

    effective = periods * max(1, packed_bits * min(1, s))

with a floor of one mandatory pass per period.  For TTFS (``s <= 1``)
this is the sparse-dataflow discount; for radix (``s ~ T/2 >= 1``) no
plane is ever empty and the full ``T`` passes are charged.

Radix at ``dataflow="bitserial"`` therefore has effective steps exactly
``T`` — the calibrated model is reproduced unchanged, which is what
anchors :meth:`EncodingCostModel.table_fit` to Tables I-III, while
:meth:`EncodingCostModel.rank_check` validates the *extension* against
the measured ``BENCH_kernels.json`` rows (the model must rank dataflows
the way the bench measures them).

Energy is modeled, not measured: ``energy_uj = power_w * latency_us``
(W x us = uJ) from the calibrated power fit — the per-image dynamic +
static energy of the modeled FPGA build.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import hwmodel
from repro_torch.core.encoding import (
    EncodingSpec,
    RadixEncoding,
    TTFSEncoding,
)

__all__ = [
    "PPAReport",
    "EncodingCostModel",
    "hw_arch_from_qnet",
    "layers_from_qnet",
    "stats_provider",
    "modeled_matmul_energy_uj",
    "KERNEL_ROW_MODEL",
]

_DATAFLOWS = (None, "fused", "bitserial")


@dataclasses.dataclass(frozen=True)
class PPAReport:
    """One (encoding, T, dataflow, units) point of the modeled PPA space.

    ``latency_us`` / ``fps`` are per-image on the modeled FPGA build;
    ``energy_uj = power_w * latency_us`` is the modeled per-image energy;
    ``klut`` / ``kff`` are the build's modeled area.  ``effective_steps``
    is the plane-pass count the encoding/dataflow pair costs (see module
    docstring) — fractional when occupancy-scaled.
    """

    encoding: str
    num_steps: int
    dataflow: Optional[str]
    units: int
    freq_mhz: float
    effective_steps: float
    cycles: float
    latency_us: float
    fps: float
    power_w: float
    energy_uj: float
    klut: float
    kff: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class EncodingCostModel:
    """The calibrated :class:`~repro_torch.core.hwmodel.CostModel` extended
    across the encoding zoo's plane-schedule algebra."""

    def __init__(self, base: Optional[hwmodel.CostModel] = None):
        self.base = base if base is not None else hwmodel.CostModel.calibrated()

    # ---- the one new number ----------------------------------------------

    def effective_steps(
        self,
        spec: EncodingSpec,
        dataflow: Optional[str] = None,
        spikes_per_act: Optional[float] = None,
    ) -> float:
        """Plane passes per image for (``spec``, ``dataflow``); see the
        module docstring for the algebra.  ``spikes_per_act`` (measured
        mean spikes per activation) occupancy-scales bit-serial passes.

        Raises:
            ValueError: unknown dataflow (must be None, "fused" or
                "bitserial").
        """
        if dataflow not in _DATAFLOWS:
            raise ValueError(
                f"dataflow must be one of {_DATAFLOWS}, got {dataflow!r}")
        if dataflow == "fused":
            return float(spec.periods)
        if dataflow == "bitserial":
            bits, periods = spec.packed_bits, spec.periods
            if spikes_per_act is None:
                return float(bits * periods)
            occupancy = min(1.0, max(float(spikes_per_act), 0.0))
            return periods * max(1.0, bits * occupancy)
        return float(spec.num_steps)

    # ---- reports ---------------------------------------------------------

    def _report(
        self,
        cycles: float,
        spec: EncodingSpec,
        dataflow: Optional[str],
        cfg: hwmodel.HwConfig,
        eff: float,
        needs_dram: bool,
    ) -> PPAReport:
        latency_us = cycles / cfg.freq_mhz
        power_w = self.base.power_w(cfg, needs_dram)
        lut, ff = self.base.resources(cfg, needs_dram)
        return PPAReport(
            encoding=spec.name, num_steps=spec.num_steps, dataflow=dataflow,
            units=cfg.n_conv_units, freq_mhz=cfg.freq_mhz,
            effective_steps=eff, cycles=cycles, latency_us=latency_us,
            fps=1e6 / latency_us, power_w=power_w,
            energy_uj=power_w * latency_us, klut=lut / 1e3, kff=ff / 1e3,
        )

    def network_report(
        self,
        net: Sequence[hwmodel.LayerShape],
        spec: EncodingSpec,
        *,
        dataflow: Optional[str] = None,
        cfg: Optional[hwmodel.HwConfig] = None,
        spikes_per_act: Optional[float] = None,
        needs_dram: bool = False,
    ) -> PPAReport:
        """Modeled per-image PPA of ``net`` under (``spec``, ``dataflow``)
        on the ``cfg`` build (default :class:`HwConfig`)."""
        cfg = cfg if cfg is not None else hwmodel.HwConfig()
        eff = self.effective_steps(spec, dataflow, spikes_per_act)
        cycles = sum(
            self.base.layer_cycles(layer, cfg, eff) for layer in net
        ) + self.base.gamma
        return self._report(cycles, spec, dataflow, cfg, eff, needs_dram)

    def matmul_report(
        self,
        m: int,
        k: int,
        n: int,
        spec: EncodingSpec,
        *,
        dataflow: Optional[str] = None,
        cfg: Optional[hwmodel.HwConfig] = None,
        spikes_per_act: Optional[float] = None,
    ) -> PPAReport:
        """Modeled PPA of an ``(m, k) @ (k, n)`` activation matmul — the
        kernel-bench problem — as ``m`` rows through the linear unit."""
        cfg = cfg if cfg is not None else hwmodel.HwConfig()
        eff = self.effective_steps(spec, dataflow, spikes_per_act)
        layer = hwmodel.LayerShape("linear", c_in=k, c_out=n)
        cycles = m * self.base.layer_cycles(layer, cfg, eff) + self.base.gamma
        return self._report(cycles, spec, dataflow, cfg, eff, False)

    # ---- validation against the paper tables -----------------------------

    def table_fit(self) -> dict:
        """Max fit errors vs Tables I-III, with Table I/II latencies
        computed *through* the encoding path (radix, bitserial) — proving
        the extension degenerates to the calibrated model exactly."""
        net = hwmodel.network_layers(*hwmodel.LENET5)
        t1 = [
            100.0 * (self.network_report(
                net, RadixEncoding(t), dataflow="bitserial",
                cfg=hwmodel.HwConfig(n_conv_units=2)).latency_us - lat) / lat
            for t, _, lat in hwmodel.PAPER_TABLE1
        ]
        t2_lat, t2_pw, t2_lut = [], [], []
        for units, lat, pw, klut, _ in hwmodel.PAPER_TABLE2:
            rep = self.network_report(
                net, RadixEncoding(3), dataflow="bitserial",
                cfg=hwmodel.HwConfig(n_conv_units=units))
            t2_lat.append(100.0 * (rep.latency_us - lat) / lat)
            t2_pw.append(rep.power_w - pw)
            t2_lut.append(rep.klut - klut)
        t3 = self.base.table3()
        return dict(
            table1_max_latency_err_pct=max(abs(e) for e in t1),
            table2_max_latency_err_pct=max(abs(e) for e in t2_lat),
            table2_max_power_err_w=max(abs(e) for e in t2_pw),
            table2_max_klut_err=max(abs(e) for e in t2_lut),
            table3_max_latency_err_pct=max(
                abs(r["lat_err_pct"]) for r in t3),
            table3_max_klut_err_pct=max(
                100.0 * abs(r["model_klut"] - r["paper_klut"])
                / r["paper_klut"] for r in t3),
        )

    # ---- validation against measured kernel-bench rows -------------------

    def rank_check(self, payload: dict) -> dict:
        """Does the model rank dataflows the way ``BENCH_kernels.json``
        measures them?  Within-encoding groups only (tuned/epilogue rows
        excluded — tile sweeps change the constant factor, not the plane
        schedule): radix fused vs bitserial; ttfs fused vs sparse vs
        dense bitserial.  Returns per-group orders + Kendall's tau."""
        cfg = payload["config"]
        m, k, n, t = cfg["m"], cfg["k"], cfg["n"], cfg["T"]
        rows = {r["name"]: r for r in payload["rows"]}
        specs = {"radix": RadixEncoding(t), "ttfs": TTFSEncoding(t)}
        groups: List[dict] = []
        pairs_total = pairs_agree = 0
        agree_all = True
        for gname, members in KERNEL_RANK_GROUPS.items():
            entries = []
            for name, dataflow, use_spikes in members:
                if name not in rows:
                    raise KeyError(
                        f"rank_check: bench payload is missing row "
                        f"{name!r} (group {gname!r})")
                row = rows[name]
                spikes = row.get("spikes_per_act") if use_spikes else None
                rep = self.matmul_report(
                    m, k, n, specs[gname], dataflow=dataflow,
                    spikes_per_act=spikes)
                entries.append(dict(
                    name=name, measured_us=row["us_per_call"],
                    modeled_us=rep.latency_us,
                    modeled_energy_uj=rep.energy_uj))
            measured = [e["name"] for e in
                        sorted(entries, key=lambda e: e["measured_us"])]
            modeled = [e["name"] for e in
                       sorted(entries, key=lambda e: e["modeled_us"])]
            for a, b in itertools.combinations(entries, 2):
                pairs_total += 1
                d_meas = a["measured_us"] - b["measured_us"]
                d_model = a["modeled_us"] - b["modeled_us"]
                if d_meas * d_model > 0:
                    pairs_agree += 1
            agree = measured == modeled
            agree_all = agree_all and agree
            groups.append(dict(group=gname, rows=entries,
                               measured_order=measured, model_order=modeled,
                               agree=agree))
        tau = (2.0 * pairs_agree - pairs_total) / pairs_total
        return dict(groups=groups, agree=agree_all,
                    pairs=pairs_total, kendall_tau=tau)


# Within-encoding rank groups: (row name, dataflow, occupancy-scaled?).
KERNEL_RANK_GROUPS: Dict[str, Tuple[Tuple[str, str, bool], ...]] = {
    "radix": (
        ("radix_fused", "fused", False),
        ("radix_bitserial_xla", "bitserial", False),
    ),
    "ttfs": (
        ("ttfs_fused", "fused", False),
        ("ttfs_bitserial_sparse", "bitserial", True),
        ("ttfs_bitserial_xla", "bitserial", False),
    ),
}

# Every kernel-bench row -> the (encoding, dataflow, occupancy-scaled?)
# point its modeled energy comes from; None = no hardware analogue
# (the float baseline).  Tuned/epilogue variants share their family's
# schedule — tile sweeps don't change the modeled plane algebra.
KERNEL_ROW_MODEL: Dict[str, Optional[Tuple[str, str, bool]]] = {
    "dense_f32": None,
    "radix_fused": ("radix", "fused", False),
    "radix_fused_tuned": ("radix", "fused", False),
    "radix_fused_epilogue": ("radix", "fused", False),
    "radix_bitserial_xla": ("radix", "bitserial", False),
    "radix_bitserial_tuned": ("radix", "bitserial", False),
    "ttfs_fused": ("ttfs", "fused", False),
    "ttfs_bitserial_xla": ("ttfs", "bitserial", False),
    "ttfs_bitserial_sparse": ("ttfs", "bitserial", True),
}


def modeled_matmul_energy_uj(
    name: str,
    m: int,
    k: int,
    n: int,
    num_steps: int,
    *,
    spikes_per_act: Optional[float] = None,
    spec: Optional[EncodingSpec] = None,
    model: Optional[EncodingCostModel] = None,
) -> Optional[float]:
    """Modeled energy of one kernel-bench row (uJ), or None for rows
    with no hardware analogue.  ``spec`` overrides the row-name lookup
    (used by the encoding-latency sweep, where the spec replays its full
    train: dataflow None)."""
    model = model if model is not None else EncodingCostModel()
    if spec is not None:
        rep = model.matmul_report(m, k, n, spec, dataflow=None)
        return rep.energy_uj
    if name not in KERNEL_ROW_MODEL:
        raise KeyError(f"no modeled-energy mapping for bench row {name!r}")
    point = KERNEL_ROW_MODEL[name]
    if point is None:
        return None
    enc, dataflow, use_spikes = point
    enc_spec = (RadixEncoding(num_steps) if enc == "radix"
                else TTFSEncoding(num_steps))
    rep = model.matmul_report(
        m, k, n, enc_spec, dataflow=dataflow,
        spikes_per_act=spikes_per_act if use_spikes else None)
    return rep.energy_uj


# ---------------------------------------------------------------------------
# Converted-net -> LayerShape bridge (conversion static + qlayer shapes).
# ---------------------------------------------------------------------------


def hw_arch_from_qnet(qnet) -> list:
    """Rebuild the hwmodel arch description from a converted net.

    Conversion-format static entries carry no shapes — kernel size and
    channel counts live in the quantized weights — so each weighted
    layer's geometry is read off its ``w_q``.

    Raises:
        ValueError: a layer kind the hardware model cannot cost.
    """
    arch = []
    for (kind, cfg), ql in zip(qnet.static, qnet.qlayers):
        if kind == "conv":
            kh, _, _, cout = (int(d) for d in ql["w_q"].shape)
            arch.append(("conv", dict(
                k=kh, c_out=cout, stride=cfg.get("stride", 1),
                padding=cfg.get("padding", "VALID"))))
        elif kind == "pool":
            arch.append(("pool", dict(window=cfg["window"])))
        elif kind == "flatten":
            arch.append(("flatten", {}))
        elif kind == "linear":
            arch.append(("linear", dict(f_out=int(ql["w_q"].shape[1]))))
        else:
            raise ValueError(
                f"hardware model cannot cost layer kind {kind!r}")
    return arch


def layers_from_qnet(qnet, item_shape) -> List[hwmodel.LayerShape]:
    """LayerShapes for a converted net; ``item_shape`` is ``(H, W, C)``
    (a flat ``(F,)`` is treated as ``(1, 1, F)`` for linear-only nets).

    Raises:
        ValueError: item shape the model cannot interpret, or a layer
            kind it cannot cost.
    """
    item = tuple(int(d) for d in item_shape)
    if len(item) == 1:
        item = (1, 1, item[0])
    if len(item) != 3:
        raise ValueError(
            f"hardware model needs an (H, W, C) item shape, got {item}")
    return hwmodel.network_layers(hw_arch_from_qnet(qnet), item)


def stats_provider(exe, cfg: Optional[hwmodel.HwConfig] = None,
                   model: Optional[EncodingCostModel] = None):
    """A zero-arg ``Executable.attach_stats`` provider reporting the
    modeled PPA of the executable's (encoding, dataflow) pairing under
    the ``"ppa"`` stats key.  Raises ``ValueError`` immediately (not at
    stats time) for nets the hardware model cannot cost, so the caller
    can skip attaching."""
    layers = layers_from_qnet(exe.qnet, exe.item_shape)
    cache: dict = {}

    def provide() -> dict:
        if "ppa" not in cache:
            m = model if model is not None else EncodingCostModel()
            rep = m.network_report(
                layers, exe.encoding, dataflow=exe.dataflow,
                cfg=cfg)
            cache["ppa"] = dict(
                latency_us=rep.latency_us, energy_uj=rep.energy_uj,
                power_w=rep.power_w, area_klut=rep.klut, area_kff=rep.kff,
                cycles=rep.cycles, effective_steps=rep.effective_steps,
                units=rep.units, freq_mhz=rep.freq_mhz,
                dataflow=rep.dataflow)
        return {"ppa": dict(cache["ppa"])}

    return provide
