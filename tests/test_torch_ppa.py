"""The port's PPA planner (``repro_torch.core.hwmodel``, ``repro_torch.ppa``,
``api.autoconfigure``, ``compile(auto=)``, ``stats()["ppa"]`` and
``serve_cnn --auto``) against the JAX package's.

* The cost models are numpy on both sides with the same op order, so the
  calibrated constants, the paper's tables and every modeled number over
  the paper's three nets and the whole (encoding, T, dataflow, units,
  occupancy) lattice are held ``==``.
* ``autoconfigure`` runs on ``tests/test_autoconfigure.py``'s LeNet-5
  smoke net (the reference's float weights carried across) with that
  file's ``KW``, once per module fixture on each side, and the plans must
  be equal: candidates, accuracies, rejection reasons, frontier, winner,
  ``summary()``.  Accuracy there is argmax fidelity against the float
  forward, whose float order differs between XLA and torch; the fixture
  first compares the two argmaxes and, where a row differs, feeds the
  reference's argmax as ``labels=`` to both sides and warns.
* A second search, at a floor where the reference finds a winner,
  compiles it.  ``convert``'s multipliers agree with the reference's to
  ``rtol=1e-5`` (its float calibration adds in another order,
  ``tests/test_torch_conversion.py``), so the port's compiled winner is
  held ``np.array_equal`` to its own oracles and to the reference's
  Executable at that rtol, and the reference winner's net carried across
  is held ``np.array_equal`` to the reference's Executable.
* Every CNN ``Executable`` reports ``stats()["ppa"]`` equal to the
  reference's, on both backends; ``compile(auto=)`` and the CLI's planner
  flags reject what the reference rejects.
"""

import dataclasses
import json
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import conversion as jconv
from repro.core import hwmodel as jhw
from repro.launch import serve_cnn as jserve
from repro.ppa import model as jppa
from repro.ppa import search as jsearch
from repro_torch import api as tapi
from repro_torch import carry
from repro_torch.core import conversion as tconv
from repro_torch.core import hwmodel as thw
from repro_torch.launch import serve_cnn as tserve
from repro_torch.ppa import model as tppa
from repro_torch.ppa import search as tsearch

REPO = pathlib.Path(__file__).resolve().parents[1]
FLOOR, SLO = 0.6, 5000.0
KW = dict(accuracy_floor=FLOOR, latency_slo_us=SLO, t_range=(3, 4),
          units=(2, 4))
WIN_FLOOR = 0.3                 # the reference finds a winner here
NETS = ("LENET5", "FANG_CNN", "VGG11_224")


# ---------------------------------------------------------------------------
# The cost models (numpy on both sides: held ==).
# ---------------------------------------------------------------------------


def test_calibrated_model_and_tables_equal():
    jm, tm = jhw.CostModel.calibrated(), thw.CostModel.calibrated()
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.table1() == jm.table1()
    assert tm.table2() == jm.table2()
    assert tm.table3() == jm.table3()
    assert (thw.PAPER_TABLE1, thw.PAPER_TABLE2, thw.PAPER_TABLE3) == \
        (jhw.PAPER_TABLE1, jhw.PAPER_TABLE2, jhw.PAPER_TABLE3)


def _hw_configs(mod):
    for units in (1, 2, 4, 8):
        for freq in (100.0, 115.0, 200.0):
            for geom in ({}, dict(conv_x=112, conv_y=3, pool_x=112),
                         dict(conv_x=48, conv_y=3, io_bus=4, cin_par=2,
                              p_linear=84)):
                yield mod.HwConfig(n_conv_units=units, freq_mhz=freq, **geom)


@pytest.mark.parametrize("net", NETS)
def test_network_cost_equal(net):
    jl = jhw.network_layers(*getattr(jhw, net))
    tl = thw.network_layers(*getattr(thw, net))
    assert [dataclasses.astuple(x) for x in tl] == \
        [dataclasses.astuple(x) for x in jl]
    jm, tm = jhw.CostModel.calibrated(), thw.CostModel.calibrated()
    for jc, tc in zip(_hw_configs(jhw), _hw_configs(thw)):
        for t in range(1, 9):
            assert tm.latency_us(tl, tc, t) == jm.latency_us(jl, jc, t)
            assert tm.throughput_fps(tl, tc, t) == \
                jm.throughput_fps(jl, jc, t)
        for dram in (False, True):
            assert tm.power_w(tc, dram) == jm.power_w(jc, dram)
            assert tm.resources(tc, dram) == jm.resources(jc, dram)
    target = jm.latency_us(jl, jhw.HwConfig(), 4) * 0.7
    assert tm.pin_io(tl, thw.HwConfig(), 4, target) == \
        jm.pin_io(jl, jhw.HwConfig(), 4, target)


def _spec_key(spec):
    return (spec.name, spec.num_steps, spec.periods)


@pytest.mark.parametrize("net", NETS)
def test_encoding_cost_model_over_the_lattice(net):
    jl = jhw.network_layers(*getattr(jhw, net))
    tl = thw.network_layers(*getattr(thw, net))
    ks = tuple(range(1, 9))
    jspecs, tspecs = jsearch._lattice(ks), tsearch._lattice(ks)
    assert [_spec_key(s) for s in tspecs] == [_spec_key(s) for s in jspecs]
    jm, tm = jppa.EncodingCostModel(), tppa.EncodingCostModel()
    n = 0
    for js, ts in zip(jspecs, tspecs):
        for dataflow in (None, "fused", "bitserial"):
            for spikes in (None, 0.0, 0.25, 1.0, 3.0):
                assert tm.effective_steps(ts, dataflow, spikes) == \
                    jm.effective_steps(js, dataflow, spikes)
                for units in (1, 2, 4, 8):
                    kw = dict(dataflow=dataflow, spikes_per_act=spikes)
                    jr = jm.network_report(
                        jl, js, cfg=jhw.HwConfig(n_conv_units=units), **kw)
                    tr = tm.network_report(
                        tl, ts, cfg=thw.HwConfig(n_conv_units=units), **kw)
                    assert tr.to_dict() == jr.to_dict()
                    n += 1
                assert tm.matmul_report(8, 256, 128, ts, dataflow=dataflow,
                                        spikes_per_act=spikes).to_dict() == \
                    jm.matmul_report(8, 256, 128, js, dataflow=dataflow,
                                     spikes_per_act=spikes).to_dict()
    assert n == len(jspecs) * 3 * 5 * 4
    with pytest.raises(ValueError, match="dataflow must be one of"):
        tm.effective_steps(tspecs[0], "rowwise")


def test_table_fit_rank_check_and_row_energy_equal():
    jm, tm = jppa.EncodingCostModel(), tppa.EncodingCostModel()
    assert tm.table_fit() == jm.table_fit()
    payload = json.loads((REPO / "BENCH_kernels.json").read_text())
    assert tm.rank_check(payload) == jm.rank_check(payload)
    assert tppa.KERNEL_ROW_MODEL == jppa.KERNEL_ROW_MODEL
    for name in jppa.KERNEL_ROW_MODEL:
        for spikes in (None, 0.4):
            assert tppa.modeled_matmul_energy_uj(
                name, 64, 128, 32, 4, spikes_per_act=spikes) == \
                jppa.modeled_matmul_energy_uj(
                    name, 64, 128, 32, 4, spikes_per_act=spikes)
    from repro.core.encoding import RateEncoding as JRate
    assert tppa.modeled_matmul_energy_uj(
        "x", 64, 128, 32, 7, spec=tapi.RateEncoding(7)) == \
        jppa.modeled_matmul_energy_uj("x", 64, 128, 32, 7, spec=JRate(7))
    for mod in (tppa, jppa):
        with pytest.raises(KeyError, match="no modeled-energy mapping"):
            mod.modeled_matmul_energy_uj("nope", 1, 1, 1, 4)


# ---------------------------------------------------------------------------
# Converted nets -> layer shapes.
# ---------------------------------------------------------------------------


def _float_net(arch, *, pool_mode, calib_batch, smoke=True):
    """The reference's float net and calibration batch, and the same net
    carried across as the port's tensors."""
    static, params, item, calib = jserve.build_float_net(
        arch, smoke=smoke, pool_mode=pool_mode, calib_batch=calib_batch,
        seed=0)
    tparams = carry.float_params_from_numpy(params)
    tcalib = torch.from_numpy(np.array(calib))
    return (static, params, item, calib), (static, tparams, item, tcalib)


@pytest.mark.parametrize("arch,pool", [("lenet5", "or"), ("fang_cnn", "avg"),
                                       ("vgg11", "avg")])
def test_layers_from_qnet_equal(arch, pool):
    (static, params, item, calib), (_, tparams, _, tcalib) = _float_net(
        arch, pool_mode=pool, calib_batch=2)
    jnet = jconv.convert(static, params, calib, num_steps=4)
    tnet = tconv.convert(static, tparams, tcalib, num_steps=4)
    assert tppa.hw_arch_from_qnet(tnet) == jppa.hw_arch_from_qnet(jnet)
    jl = jppa.layers_from_qnet(jnet, item)
    tl = tppa.layers_from_qnet(tnet, item)
    assert [dataclasses.astuple(x) for x in tl] == \
        [dataclasses.astuple(x) for x in jl]
    for mod, net in ((tppa, tnet), (jppa, jnet)):
        with pytest.raises(ValueError, match=r"\(H, W, C\) item shape"):
            mod.layers_from_qnet(net, item[:2])


def test_layers_from_a_flat_item_and_an_uncostable_kind():
    static = (("linear", {}), ("linear", {}))
    rng = np.random.default_rng(3)
    params = [{"w": rng.normal(size=(12, 8)).astype(np.float32),
               "b": np.zeros(8, np.float32)},
              {"w": rng.normal(size=(8, 4)).astype(np.float32),
               "b": np.zeros(4, np.float32)}]
    calib = rng.uniform(0, 1, (4, 12)).astype(np.float32)
    jnet = jconv.convert(static, params, jnp.asarray(calib), num_steps=4)
    tnet = tconv.convert(static, carry.float_params_from_numpy(params),
                         torch.from_numpy(calib), num_steps=4)
    assert [dataclasses.astuple(x) for x in
            tppa.layers_from_qnet(tnet, (12,))] == \
        [dataclasses.astuple(x) for x in jppa.layers_from_qnet(jnet, (12,))]
    for mod, net in ((tppa, tnet), (jppa, jnet)):
        bad = dataclasses.replace(net, static=(("dense", {}),) + static[1:])
        with pytest.raises(ValueError, match="cannot cost layer kind"):
            mod.hw_arch_from_qnet(bad)


# ---------------------------------------------------------------------------
# autoconfigure on tests/test_autoconfigure.py's LeNet-5 smoke net.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lenet_nets():
    return _float_net("lenet5", pool_mode="avg", calib_batch=32)


@pytest.fixture(scope="module")
def labels(lenet_nets):
    """None where the two float forwards give the same argmax; else the
    reference's argmax, fed to both searches as ``labels=``."""
    (static, params, _, calib), (_, tparams, _, tcalib) = lenet_nets
    jarg = np.argmax(np.asarray(jconv.float_forward(static, params, calib)),
                     -1)
    targ = np.argmax(tconv.float_forward(static, tparams, tcalib).numpy(),
                     -1)
    rows = np.nonzero(jarg != targ)[0]
    if rows.size:
        warnings.warn(f"float argmax differs from the reference's at rows "
                      f"{rows.tolist()}: scoring both searches against the "
                      "reference's argmax as labels=")
        return jarg
    return None


def _search(nets, labels, **kw):
    (static, params, item, calib), (_, tparams, _, tcalib) = nets
    jplan = jsearch.autoconfigure((static, params), item, calib=calib,
                                  labels=labels, **kw)
    tplan = tsearch.autoconfigure((static, tparams), item, calib=tcalib,
                                  labels=labels, device="cpu", **kw)
    return jplan, tplan


@pytest.fixture(scope="module")
def plans(lenet_nets, labels):
    return _search(lenet_nets, labels, **KW)


@pytest.fixture(scope="module")
def win_plans(lenet_nets, labels):
    return _search(lenet_nets, labels, **dict(KW, accuracy_floor=WIN_FLOOR))


def _candidates(plan):
    return [(c.label, c.backend, c.dataflow, c.units, c.accuracy,
             None if c.ppa is None else c.ppa.to_dict(), c.rejected)
            for c in plan.candidates]


def _assert_plans_equal(jplan, tplan):
    assert _candidates(tplan) == _candidates(jplan)
    assert tplan.to_dict() == jplan.to_dict()
    assert tplan.summary() == jplan.summary()
    assert [c.label for c in tplan.frontier] == \
        [c.label for c in jplan.frontier]
    assert (tplan.winner is None) == (jplan.winner is None)
    if jplan.winner is not None:
        assert tplan.winner.label == jplan.winner.label
    assert (tplan.accuracy_evals, tplan.calib_size) == \
        (jplan.accuracy_evals, jplan.calib_size)


def test_float_argmax_agrees_but_for_near_ties(lenet_nets, labels):
    (static, params, _, calib), _ = lenet_nets
    if labels is None:
        return
    logits = np.sort(np.asarray(jconv.float_forward(static, params, calib)),
                     -1)
    gap = (logits[:, -1] - logits[:, -2]) / np.abs(logits[:, -1])
    assert gap.min() < 1e-5


def test_plan_equals_reference(plans):
    jplan, tplan = plans
    _assert_plans_equal(jplan, tplan)
    assert jplan.winner is None and tplan.frontier == []
    assert any("accuracy" in r for c in tplan.candidates for r in c.rejected)
    with pytest.raises(ValueError, match="no feasible configuration"):
        tplan.compile()


def test_compile_a_chosen_candidate(plans, lenet_nets):
    """With no winner, ``compile(candidate=)`` still compiles any priced
    candidate of the plan, exact to its oracles; one the search did not
    price (or another plan's) raises."""
    _, tplan = plans
    (_, _, _, tcalib) = lenet_nets[1]
    top = max((c for c in tplan.candidates if c.ppa is not None),
              key=lambda c: (c.accuracy, -c.ppa.energy_uj))
    exe = tplan.compile(candidate=top, buckets=(4,))
    assert (exe.encoding.name, exe.backend, exe.dataflow) == \
        (top.spec.name, top.backend, top.dataflow)
    got = exe(tcalib[:4])
    for mode in ("snn", "packed"):
        assert torch.equal(got, tapi.oracle(exe.qnet, tcalib[:4], mode=mode))
    assert exe.stats()["ppa"]["units"] == thw.HwConfig().n_conv_units
    unpriced = next((c for c in tplan.candidates if c.ppa is None), None)
    stranger = dataclasses.replace(top, units=top.units + 1000)
    for bad in filter(None, (unpriced, stranger)):
        with pytest.raises(ValueError, match="not a priced candidate"):
            tplan.compile(candidate=bad)


def test_winner_compiles_exact(win_plans, lenet_nets):
    jplan, tplan = win_plans
    _assert_plans_equal(jplan, tplan)
    assert tplan.winner is not None
    (_, _, _, calib), (_, _, _, tcalib) = lenet_nets
    jexe = jplan.compile(buckets=(4,))
    texe = tplan.compile(buckets=(4,))
    assert (texe.encoding.name, texe.backend, texe.dataflow) == \
        (jexe.encoding.name, jexe.backend, jexe.dataflow)
    want = np.asarray(jexe(calib[:4]))
    got = texe(tcalib[:4]).numpy()
    tq = tplan._qnets[tplan.winner.spec]
    for mode in ("snn", "packed"):
        np.testing.assert_array_equal(
            got, tapi.oracle(tq, tcalib[:4], mode=mode).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the reference winner's own net, carried across: bit-exact
    jq = jplan._qnets[jplan.winner.spec]
    carried = carry.qnet_from_numpy(
        jq.static, [None if qp is None else {
            k: None if qp[k] is None else np.asarray(qp[k])
            for k in ("w_q", "b_int", "mult")} for qp in jq.qlayers],
        num_steps=jq.num_steps, weight_bits=jq.weight_bits,
        input_scale=jq.input_scale, logit_scale=np.asarray(jq.logit_scale),
        encoding=jq.spec)
    cexe = tapi.Accelerator(backend=jexe.backend, dataflow=jexe.dataflow,
                            device="cpu").compile(carried, jexe.item_shape,
                                                  buckets=(4,))
    np.testing.assert_array_equal(cexe(tcalib[:4]).numpy(), want)
    assert texe.stats()["ppa"] == jexe.stats()["ppa"] == cexe.stats()["ppa"]
    assert texe.stats()["ppa"]["latency_us"] == tplan.winner.ppa.latency_us


@pytest.mark.parametrize("case", ["latency", "or_pool"])
def test_other_searches_equal_reference(case, lenet_nets, labels):
    if case == "latency":
        jplan, tplan = _search(lenet_nets, labels, objective="latency",
                               **dict(KW, accuracy_floor=WIN_FLOOR))
        assert tplan.winner.ppa.latency_us == min(
            c.ppa.latency_us for c in tplan.frontier)
    else:
        nets = _float_net("lenet5", pool_mode="or", calib_batch=8)
        jplan, tplan = _search(nets, None, accuracy_floor=0.01,
                               t_range=(3,), units=(2,))
        spec_level = {c.spec.name for c in tplan.candidates
                      if c.backend == "-"}
        assert {"rate", "ttfs"} <= spec_level
    _assert_plans_equal(jplan, tplan)


BAD_SEARCH = {
    "qnet": (dict(net="qnet"), TypeError, "QuantizedNet"),
    "not-a-pair": (dict(net=42), TypeError, "pair"),
    "objective": (dict(objective="area"), ValueError, "objective"),
    "empty-t": (dict(t_range=()), ValueError, "non-empty"),
    "empty-units": (dict(units=()), ValueError, "non-empty"),
    "calib-shape": (dict(item=(8, 8, 3)), ValueError, "calib item shape"),
}


@pytest.mark.parametrize("case", sorted(BAD_SEARCH))
def test_search_rejects_like_reference(case, lenet_nets):
    kw, exc, match = BAD_SEARCH[case]
    kw = dict(kw)
    (static, params, item, calib), (_, tparams, _, tcalib) = lenet_nets
    sides = [(jsearch, jconv, (static, params), calib, {}),
             (tsearch, tconv, (static, tparams), tcalib,
              dict(device="cpu"))]
    for search, conv, net, cal, extra in sides:
        net = {"qnet": conv.convert(*net, cal, num_steps=4),
               42: 42}.get(kw.get("net"), net)
        args = {k: v for k, v in kw.items() if k not in ("net", "item")}
        with pytest.raises(exc, match=match):
            search.autoconfigure(net, kw.get("item", item), calib=cal,
                                 accuracy_floor=0.5, **args, **extra)


# ---------------------------------------------------------------------------
# api: autoconfigure, compile(auto=), stats()["ppa"].
# ---------------------------------------------------------------------------


def test_api_autoconfigure_and_compile_auto(lenet_nets, labels):
    (static, params, item, calib), (_, tparams, _, tcalib) = lenet_nets
    auto = dict(accuracy_floor=WIN_FLOOR, t_range=(3,), units=(2,),
                labels=labels)
    tplan = tapi.autoconfigure((static, tparams), item, calib=tcalib,
                               device="cpu", **auto)
    jplan = japi.autoconfigure((static, params), item, calib=calib, **auto)
    assert isinstance(tplan, tsearch.AutoPlan)
    _assert_plans_equal(jplan, tplan)
    jexe = japi.Accelerator().compile((static, params), item,
                                      auto=dict(auto, calib=calib),
                                      buckets=(2,))
    texe = tapi.Accelerator(device="cpu").compile(
        (static, tparams), item, auto=dict(auto, calib=tcalib),
        buckets=(2,))
    _assert_plans_equal(jexe.auto_plan, texe.auto_plan)
    assert texe.encoding == texe.auto_plan.winner.spec
    assert texe.device == torch.device("cpu")
    got = texe(tcalib[:2]).numpy()
    np.testing.assert_array_equal(got, tapi.oracle(
        texe.qnet, tcalib[:2], mode="snn").numpy())
    np.testing.assert_allclose(got, np.asarray(jexe(calib[:2])), rtol=1e-5)
    assert texe.stats()["ppa"] == jexe.stats()["ppa"]


def test_compile_auto_rejects_like_reference(lenet_nets):
    (static, params, item, calib), (_, tparams, _, tcalib) = lenet_nets
    sides = [(japi, (static, params), calib, {}),
             (tapi, (static, tparams), tcalib, dict(device="cpu"))]
    for api, net, cal, dev in sides:
        auto = dict(calib=cal, accuracy_floor=0.5)
        with pytest.raises(ValueError, match="dataflow"):
            api.Accelerator(dataflow="fused", **dev).compile(net, item,
                                                             auto=auto)
        with pytest.raises(ValueError, match="encoding"):
            api.Accelerator(**dev).compile(
                net, item, auto=auto, encoding=api.RadixEncoding(4))
        with pytest.raises(ValueError, match="no feasible configuration"):
            api.Accelerator(**dev).compile(
                net, item, auto=dict(auto, accuracy_floor=2.0,
                                     t_range=(3,), units=(2,)))
    # data-parallel bucket plans are ported: the planner's winner compiles
    # with parallel=2, clamped to one shard on the one visible CPU device
    exe = tapi.Accelerator(device="cpu").compile(
        (static, tparams), item, parallel=2, buckets=(2,),
        auto=dict(calib=tcalib, accuracy_floor=WIN_FLOOR, t_range=(3,),
                  units=(2,)))
    assert exe.parallel == 2
    assert getattr(exe.plan_for(2), "data_parallel", 1) == 1
    np.testing.assert_array_equal(exe(tcalib[:2]).numpy(), tapi.oracle(
        exe.qnet, tcalib[:2], mode="snn").numpy())


# (pool mode, encoding, backend, dataflow)
PPA_CASES = [("avg", "radix", "kernels", "fused"),
             ("avg", "radix", "kernels", "bitserial"),
             ("avg", "radix", "jnp", None),
             ("avg", "ttfs", "kernels", "bitserial"),
             ("avg", "rate", "jnp", None),
             ("or", "phase", "kernels", "fused")]


@pytest.mark.parametrize("pool,enc,backend,dataflow", PPA_CASES)
def test_every_executable_reports_the_reference_ppa(pool, enc, backend,
                                                    dataflow):
    (static, params, item, calib), (_, tparams, _, tcalib) = _float_net(
        "lenet5", pool_mode=pool, calib_batch=4)
    steps, periods = (8, 2) if enc == "phase" else (4, 1)
    jspec = jserve.make_encoding(enc, steps, periods=periods)
    tspec = tserve.make_encoding(enc, steps, periods=periods)
    jnet = jconv.convert(static, params, calib, encoding=jspec)
    tnet = tconv.convert(static, tparams, tcalib, encoding=tspec)
    jexe = japi.Accelerator(backend=backend, dataflow=dataflow).compile(
        jnet, item, buckets=(2,))
    texe = tapi.Accelerator(backend=backend, dataflow=dataflow,
                            device="cpu").compile(tnet, item, buckets=(2,))
    assert texe.stats()["ppa"] == jexe.stats()["ppa"]
    assert list(texe.stats()) == list(jexe.stats())
    # a net the model cannot cost simply lacks the key, on both sides
    jflat = japi.Accelerator(backend=backend, dataflow=dataflow).compile(
        jnet, item[:2], buckets=(2,))
    tflat = tapi.Accelerator(backend=backend, dataflow=dataflow,
                             device="cpu").compile(tnet, item[:2],
                                                   buckets=(2,))
    assert "ppa" not in tflat.stats() and "ppa" not in jflat.stats()


# ---------------------------------------------------------------------------
# serve_cnn's planner flags.
# ---------------------------------------------------------------------------

CLI_ERRORS = {
    **{f"conflict{flag[0]}": (["--auto"] + flag, "conflicts with --auto")
       for flag in (["--encoding", "ttfs"], ["--num-steps", "4"],
                    ["--dataflow", "fused"], ["--backend", "jnp"],
                    ["--periods", "2"])},
    **{f"needs-auto{flag[0]}": (flag, "requires --auto")
       for flag in (["--accuracy-floor", "0.9"], ["--latency-slo", "100"],
                    ["--energy-budget", "50"])},
    "floor-high": (["--auto", "--accuracy-floor", "1.5"], "accuracy-floor"),
    "floor-zero": (["--auto", "--accuracy-floor", "0"], "accuracy-floor"),
    "slo": (["--auto", "--latency-slo", "-1"], "latency-slo"),
    "energy": (["--auto", "--energy-budget", "0"], "energy-budget"),
}


@pytest.mark.parametrize("case", sorted(CLI_ERRORS))
def test_cli_planner_flags_rejected_like_reference(case, capsys):
    extra, match = CLI_ERRORS[case]
    errs = []
    for mod in (jserve, tserve):
        with pytest.raises(SystemExit) as exc:
            mod._parse_args(["--arch", "lenet5", "--smoke"] + extra)
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert match in errs[1]
    assert errs[0].split("error:")[-1] == errs[1].split("error:")[-1]


def test_cli_planner_flags_parse_like_reference():
    for extra in (["--auto"], ["--auto", "--accuracy-floor", "0.7",
                               "--latency-slo", "800",
                               "--energy-budget", "2500"]):
        argv = ["--arch", "lenet5", "--smoke"] + extra
        j, t = jserve._parse_args(argv), tserve._parse_args(argv)
        fields = ("auto", "accuracy_floor", "latency_slo", "energy_budget",
                  "encoding", "num_steps", "periods", "bucket_ladder")
        assert [getattr(t, f) for f in fields] == \
            [getattr(j, f) for f in fields]


def test_cli_auto_serves_every_request_on_cpu(monkeypatch):
    from repro_torch.runtime import resilience as rz
    from repro_torch.runtime.straggler import StragglerMonitor

    health = rz.HealthMonitor
    monkeypatch.setattr(rz, "HealthMonitor",
                        lambda: health(StragglerMonitor(threshold=1e9)))
    out = tserve.main(["--arch", "lenet5", "--smoke", "--auto",
                       "--pool-mode", "avg", "--accuracy-floor", "0.3",
                       "--latency-slo", "5000", "--device", "cpu",
                       "--requests", "6", "--buckets", "1,4,8"])
    plan = out["plan"]
    assert plan.winner is not None and plan.calib_size == 64
    assert out["ok"] == out["requests"] == 6
    assert out["stats"]["compiles"] == 3
    assert out["stats"]["ppa"]["latency_us"] == plan.winner.ppa.latency_us
    # --data-parallel is ported: on the one CPU device it clamps to one
    # shard and serves the same stream
    par = tserve.main(["--arch", "lenet5", "--smoke", "--device", "cpu",
                       "--requests", "6", "--buckets", "1,4,8",
                       "--data-parallel", "2"])
    assert par["ok"] == par["requests"] == 6
    assert par["stats"]["compiles"] == 3
