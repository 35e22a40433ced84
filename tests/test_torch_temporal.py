"""The port's rate, TTFS and phase encodings, its ``jnp`` backend and Fang
CNN-2 against the JAX package.

* Every spec for T = 1..8 (phase at every P dividing T): ``quantize``,
  ``requantize``, ``encode`` (exhaustive over levels), ``decode``,
  ``reduce_planes``, ``representable_levels`` and the declarations:
  ``np.array_equal``.
* ``rate_encode``: the deterministic variant equal; the stochastic one
  (a ``torch.Generator`` cannot repeat ``jax.random``) by its law.
* ``support_matrix()`` and its markdown equal; the same inputs raise in
  both packages.
* ``convert`` of LeNet-5 and Fang at width 0.25 per spec, on float nets
  whose weights, biases and inputs lie on dyadic grids, so that the float
  calibration forward is exact in any summation order (checked first):
  ``w_q``, ``b_int``, ``mult``, ``input_scale`` and ``logit_scale`` equal.
* Plans on the CPU (the kernels' plain versions) for TTFS (avg and max
  pool) and phase (8, 2) in both dataflows, and the ``jnp`` backend for
  rate and radix, over nets the reference converted and carried across:
  logits ``np.array_equal`` to the reference's spike-plane oracle; one
  case per spec also equal to the reference's ``Executable`` on the same
  backend (Pallas in interpret mode for kernels), with equal plane
  counters.

Every comparison is exact (no tolerance) except the stochastic rate
encoder's spike frequency, held to 5 binomial standard deviations.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import SNN_ARCHS as J_SNN_ARCHS
from repro.core import conversion as jconv
from repro.core import encoding as jenc
from repro.models import fang as jfang
from repro.models import lenet as jlenet
from repro_torch import api, carry, configs
from repro_torch.core import conversion as tconv
from repro_torch.core import encoding as tenc
from repro_torch.models import fang

REQUESTS = (1, 3, 8, 11)
BUCKETS = (1, 8)


def _spec_pairs():
    pairs = []
    for t in range(1, 9):
        pairs += [(tenc.RadixEncoding(t), jenc.RadixEncoding(t)),
                  (tenc.RateEncoding(t), jenc.RateEncoding(t)),
                  (tenc.TTFSEncoding(t), jenc.TTFSEncoding(t))]
        pairs += [(tenc.PhaseEncoding(t, periods=p),
                   jenc.PhaseEncoding(t, periods=p))
                  for p in range(1, t + 1) if t % p == 0]
    return pairs


SPEC_PAIRS = _spec_pairs()


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Spec numerics, exhaustive over levels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", SPEC_PAIRS, ids=lambda p: repr(p[0]))
def test_spec_matches_reference(pair):
    t, j = pair
    assert (t.name, t.levels, t.max_level, t.packed_bits, t.radix_planes,
            t.scale_factor, t.periods, t.backends, t.kernel_dataflows,
            t.pool_modes, t.levels_doc) == (
        j.name, j.levels, j.max_level, j.packed_bits, j.radix_planes,
        j.scale_factor, j.periods, j.backends, j.kernel_dataflows,
        j.pool_modes, j.levels_doc)
    np.testing.assert_array_equal(t.plane_weights(), j.plane_weights())
    np.testing.assert_array_equal(t.representable_levels(),
                                  j.representable_levels())
    if t.kernel_dataflows:
        ts, js = t.kernel_schedule(), j.kernel_schedule()
        assert (ts.packed_bits, ts.periods, ts.out_level, ts.out_grid) == (
            js.packed_bits, js.periods, js.out_level, js.out_grid)

    # quantize: a sweep plus every grid point (and points past full
    # scale), scalar and per-channel scale; one shape for every spec
    x = np.concatenate([np.linspace(-0.3, 1.3, 997, dtype=np.float32),
                        np.arange(257, dtype=np.float32)
                        / np.float32(t.levels)])
    for scale in (1.0, 0.37):
        _eq(t.quantize(torch.from_numpy(x), scale),
            j.quantize(jnp.asarray(x), scale))
    x2 = x[:996].reshape(-1, 4)
    sc = np.asarray([1.0, 0.37, 0.813, 2.5], np.float32)
    _eq(t.quantize(torch.from_numpy(x2), torch.from_numpy(sc)),
        j.quantize(jnp.asarray(x2), jnp.asarray(sc)))

    # requantize: scalar and per-channel multipliers
    acc = np.arange(-40, 3000, dtype=np.int32)
    for mult in (0.0173, 0.31):
        m = np.float32(mult)
        _eq(t.requantize(torch.from_numpy(acc), torch.tensor(m)),
            j.requantize(jnp.asarray(acc), jnp.asarray(m)))
    acc2 = acc[:3040].reshape(-1, 4)
    mrow = np.asarray([0.0173, 0.31, 0.002, 0.125], np.float32)
    _eq(t.requantize(torch.from_numpy(acc2), torch.from_numpy(mrow)),
        j.requantize(jnp.asarray(acc2), jnp.asarray(mrow)))

    # encode every level it is defined on (TTFS: every radix level)
    top = (1 << t.num_steps) if t.name == "ttfs" else t.levels
    q = np.arange(top, dtype=np.int32).astype(
        np.uint8 if top <= 256 else np.int32)
    planes = t.encode(torch.from_numpy(q))
    _eq(planes, j.encode(jnp.asarray(q)))
    rep = t.representable_levels().astype(np.int32)
    np.testing.assert_array_equal(
        t.decode(t.encode(torch.from_numpy(rep))).numpy(), rep)

    rng = np.random.default_rng(t.num_steps)
    bits = rng.integers(0, 2, (t.num_steps, 64)).astype(np.int8)
    _eq(t.decode(torch.from_numpy(bits)), j.decode(jnp.asarray(bits)))
    per = rng.integers(-9, 50, (t.num_steps, 5, 7)).astype(np.int32)
    _eq(t.reduce_planes(torch.from_numpy(per)),
        j.reduce_planes(jnp.asarray(per)))


def test_rate_encode_deterministic_matches_reference():
    x = np.random.default_rng(2).uniform(-0.2, 1.4, (6, 7, 3)).astype(
        np.float32)
    for steps in (1, 4, 8, 16):
        for scale in (1.0, 0.8):
            _eq(tenc.rate_encode(torch.from_numpy(x), steps, scale),
                jenc.rate_encode(jnp.asarray(x), steps, scale))
            planes = tenc.rate_encode(torch.from_numpy(x), steps, scale)
            _eq(tenc.rate_decode(planes, scale),
                jenc.rate_decode(jnp.asarray(planes.numpy()), scale))


def test_rate_encode_stochastic_law():
    """Bernoulli spikes at probability ``clip(x / scale, 0, 1)``: each
    element's frequency over 4096 steps within 5 binomial standard
    deviations, 0 and 1 exactly at the clip ends, and one generator seed
    repeats its draw."""
    steps, scale = 4096, 2.0
    x = torch.tensor([-1.0, 0.0, 0.2, 0.7, 1.0, 1.5, 2.0, 3.0])
    p = torch.clamp(x / scale, 0, 1)
    planes = tenc.rate_encode(x, steps, scale,
                              generator=torch.Generator().manual_seed(7))
    assert planes.shape == (steps, 8) and planes.dtype == torch.int8
    assert set(planes.unique().tolist()) <= {0, 1}
    freq = planes.double().mean(0)
    sd = torch.sqrt(p.double() * (1 - p.double()) / steps)
    assert bool(((freq - p.double()).abs() <= 5 * sd + 1e-12).all()), freq
    assert freq[0] == 0 and freq[1] == 0 and bool((freq[-2:] == 1).all())
    again = tenc.rate_encode(x, steps, scale,
                             generator=torch.Generator().manual_seed(7))
    assert torch.equal(planes, again)


def test_support_matrix_matches_reference():
    assert tenc.support_matrix() == jenc.support_matrix()
    assert tenc.support_matrix_markdown() == jenc.support_matrix_markdown()
    assert [c.name for c in api.SPECS] == [c.name for c in japi.SPECS]
    assert api.support_matrix() == japi.support_matrix()


# ---------------------------------------------------------------------------
# Validation errors at the same inputs.
# ---------------------------------------------------------------------------


def _both_raise(fn_t, fn_j):
    with pytest.raises(ValueError):
        fn_t()
    with pytest.raises(ValueError):
        fn_j()


def _lenet(pool):
    return jlenet.static(pool)[0]


INVALID = {
    "phase-periods-not-dividing": lambda e: e.PhaseEncoding(6, periods=4),
    "phase-periods-zero": lambda e: e.PhaseEncoding(4, periods=0),
    "num-steps-zero": lambda e: e.TTFSEncoding(0),
    "rate-scale-zero": lambda e: e.RateEncoding(4, scale=0.0),
    "rate-or-pool": lambda e: e.RateEncoding(4).validate_static(
        _lenet("or")),
    "rate-max-pool": lambda e: e.RateEncoding(4).validate_static(
        _lenet("max")),
    "ttfs-or-pool": lambda e: e.TTFSEncoding(4).validate_static(
        _lenet("or")),
    "rate-kernel-schedule": lambda e: e.RateEncoding(4).kernel_schedule(),
    "rate-dataflow": lambda e: e.RateEncoding(4).validate_dataflow(None),
    "ttfs-unknown-dataflow": lambda e: e.TTFSEncoding(4).validate_dataflow(
        "rowwise"),
    "phase-unknown-dataflow": lambda e: e.PhaseEncoding(
        8, periods=2).validate_dataflow("tiled"),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_spec_validation_errors_match_reference(case):
    _both_raise(lambda: INVALID[case](tenc), lambda: INVALID[case](jenc))


@pytest.fixture(scope="module")
def rate_nets():
    """LeNet-5 (width 0.25, avg pool) converted for rate by the reference
    and carried across."""
    static, params, hw = jlenet.make(jax.random.PRNGKey(1), pool_mode="avg",
                                     width_mult=0.25)
    calib = np.random.default_rng(4).uniform(0, 1, (4,) + hw).astype(
        np.float32)
    jnet = jconv.convert(static, params, jnp.asarray(calib),
                         encoding=jenc.RateEncoding(4))
    return jnet, _carry(jnet), hw


def test_compile_errors_match_reference(rate_nets):
    jnet, tnet, hw = rate_nets
    cpu = dict(device="cpu")
    # rate has no kernel dataflow
    _both_raise(lambda: api.Accelerator(**cpu).compile(tnet, hw),
                lambda: japi.Accelerator().compile(jnet, hw))
    # a dataflow names an in-kernel schedule: not with the jnp backend
    _both_raise(lambda: api.Accelerator(backend="jnp", dataflow="fused"),
                lambda: japi.Accelerator(backend="jnp", dataflow="fused"))
    _both_raise(lambda: api.Accelerator(backend="tpu"),
                lambda: japi.Accelerator(backend="tpu"))
    _both_raise(
        lambda: api.Accelerator(backend="jnp", **cpu).compile(
            tnet, hw, parallel=2),
        lambda: japi.Accelerator(backend="jnp").compile(jnet, hw,
                                                        parallel=2))
    _both_raise(
        lambda: api.Accelerator(backend="jnp", **cpu).compile(
            tnet, hw, encoding=api.RateEncoding(5)),
        lambda: japi.Accelerator(backend="jnp").compile(
            jnet, hw, encoding=japi.RateEncoding(5)))
    exe = api.Accelerator(backend="jnp", **cpu).compile(tnet, hw,
                                                       buckets=(2,))
    with pytest.raises(NotImplementedError, match="kernel plans"):
        exe.traffic()
    # the pool pairing is checked by convert too
    static, params, hw = jlenet.make(jax.random.PRNGKey(1), pool_mode="or",
                                     width_mult=0.25)
    calib = np.zeros((2,) + hw, np.float32)
    _both_raise(
        lambda: tconv.convert(static, carry.float_params_from_numpy(params),
                              torch.from_numpy(calib),
                              encoding=tenc.TTFSEncoding(4)),
        lambda: jconv.convert(static, params, jnp.asarray(calib),
                              encoding=jenc.TTFSEncoding(4)))


# ---------------------------------------------------------------------------
# Fang CNN-2 and the CNN registry.
# ---------------------------------------------------------------------------


def test_fang_model_and_registry_match_reference():
    for pool in ("or", "avg", "max"):
        for width in (1.0, 0.25, 0.1):
            assert fang.static(pool, width) == jfang.static(pool, width)
    for width in (1.0, 0.25):
        st, params, hw = fang.make(np.random.default_rng(0), "max", width)
        assert (st, hw) == (jfang.static("max", width)[0], jfang.INPUT_HW)
        jparams = jax.eval_shape(lambda k: jfang.init(k, width),
                                 jax.random.PRNGKey(0))
        for p, jp in zip(params, jparams):
            assert (p is None) == (jp is None)
            if p is not None:
                assert tuple(p["w"].shape) == jp["w"].shape
                assert tuple(p["b"].shape) == jp["b"].shape
                assert p["w"].dtype == torch.float32
                assert not bool(p["b"].any())
    assert configs.SNN_ARCHS == J_SNN_ARCHS
    assert configs.LM_ARCHS == ["gemma_2b", "glm4_9b", "gemma_7b",
                                "deepseek_coder_33b", "recurrentgemma_2b",
                                "rwkv6_3b", "grok_1_314b", "kimi_k2_1t_a32b",
                                "whisper_medium", "qwen2_vl_72b"]
    assert configs.get_snn("fang-cnn") is fang.make
    with pytest.raises(ValueError):
        configs.get_snn("gemma_2b")


# ---------------------------------------------------------------------------
# Conversion per spec, on dyadic-grid nets.
# ---------------------------------------------------------------------------

CONVERT_SPECS = [
    ("or", "radix", {}), ("avg", "rate", {}), ("avg", "rate", {"scale": 2.0}),
    ("avg", "ttfs", {}), ("max", "ttfs", {}), ("or", "phase", {"periods": 2}),
]
MAKERS = {"lenet5": jlenet.make, "fang_cnn": jfang.make}


def _spec_of(pkg, name, fields):
    cls = {"radix": pkg.RadixEncoding, "rate": pkg.RateEncoding,
           "ttfs": pkg.TTFSEncoding, "phase": pkg.PhaseEncoding}[name]
    return cls(8 if name == "phase" else 4, **fields)


def _grid_net(arch, pool, seed):
    """Weights on a quarter grid, biases on an eighth grid, inputs on a
    sixteenth grid: every float of the calibration forward is exact."""
    static, params, hw = MAKERS[arch](jax.random.PRNGKey(seed),
                                      pool_mode=pool, width_mult=0.25)
    rng = np.random.default_rng(seed)
    params = [None if p is None else {
        "w": np.round(np.asarray(p["w"]) * 4).astype(np.float32) / 4,
        "b": (rng.integers(-4, 5, p["b"].shape) / 8).astype(np.float32)}
        for p in params]
    calib = (np.random.default_rng(seed + 1).integers(0, 17, (6,) + hw)
             / 16).astype(np.float32)
    return static, params, calib


@pytest.mark.parametrize("arch", sorted(MAKERS))
@pytest.mark.parametrize("case", CONVERT_SPECS,
                         ids=lambda c: c[1] + "-" + c[0] + "".join(
                             f"-{k}{v}" for k, v in c[2].items()))
def test_convert_per_spec_matches_reference(arch, case):
    pool, name, fields = case
    static, params, calib = _grid_net(arch, pool, 3)
    jparams = [None if p is None else {k: jnp.asarray(v)
                                       for k, v in p.items()}
               for p in params]
    tparams = carry.float_params_from_numpy(params)
    _, jacts = jconv.float_forward(static, jparams, jnp.asarray(calib),
                                   return_activations=True)
    _, tacts = tconv.float_forward(static, tparams, torch.from_numpy(calib),
                                   return_activations=True)
    for a, b in zip(jacts, tacts):            # the premise: an exact forward
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jnet = jconv.convert(static, jparams, jnp.asarray(calib),
                         encoding=_spec_of(jenc, name, fields))
    tnet = tconv.convert(static, tparams, torch.from_numpy(calib),
                         encoding=_spec_of(tenc, name, fields))
    got = carry.qnet_to_numpy(tnet)
    assert got["input_scale"] == jnet.input_scale
    np.testing.assert_array_equal(got["logit_scale"],
                                  np.asarray(jnet.logit_scale))
    assert got["encoding"] == jnet.spec.name
    for k, v in fields.items():
        assert got[k] == getattr(jnet.spec, k) == v
    for g, w in zip(got["qlayers"], jnet.qlayers):
        assert (g is None) == (w is None)
        if w is None:
            continue
        for k in ("w_q", "b_int", "mult"):
            if w[k] is None:
                assert g[k] is None
            else:
                assert g[k].dtype == np.asarray(w[k]).dtype
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    back = carry.qnet_from_numpy(**got)
    assert back.spec == tnet.spec


# ---------------------------------------------------------------------------
# Plans per spec against the reference.
# ---------------------------------------------------------------------------


def _carry(jnet):
    return carry.qnet_from_numpy(
        jnet.static,
        [None if qp is None else {k: None if qp[k] is None
                                  else np.asarray(qp[k])
                                  for k in ("w_q", "b_int", "mult")}
         for qp in jnet.qlayers],
        num_steps=jnet.num_steps, weight_bits=jnet.weight_bits,
        input_scale=jnet.input_scale, logit_scale=jnet.logit_scale,
        encoding=jnet.spec)


PLAN_CASES = {
    # id: (arch, pool, spec name, fields, backend)
    "ttfs-avg": ("fang_cnn", "avg", "ttfs", (), "kernels"),
    "ttfs-max": ("lenet5", "max", "ttfs", (), "kernels"),
    "phase-8-2-or": ("fang_cnn", "or", "phase", (("periods", 2),),
                     "kernels"),
    "rate-avg": ("lenet5", "avg", "rate", (), "jnp"),
    "radix-or": ("fang_cnn", "or", "radix", (), "jnp"),
}


@functools.lru_cache(maxsize=None)
def _plan_net(key):
    """The case's net converted by the reference, carried across, its
    request batch and the reference's spike-plane oracle logits."""
    arch, pool, name, fields, backend = PLAN_CASES[key]
    static, params, hw = MAKERS[arch](jax.random.PRNGKey(5), pool_mode=pool,
                                      width_mult=0.25)
    calib = np.random.default_rng(17).uniform(0, 1, (8,) + hw).astype(
        np.float32)
    jnet = jconv.convert(static, params, jnp.asarray(calib),
                         encoding=_spec_of(jenc, name, dict(fields)))
    x = np.random.default_rng(23).uniform(0, 1, (sum(REQUESTS),) + hw
                                          ).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: japi.oracle(jnet, x, mode="snn"))(
        jnp.asarray(x)))
    assert want.std(0).mean() > 0, "degenerate net"
    return jnet, _carry(jnet), hw, x, want, backend


def _serve(exe, x):
    outs, off = [], 0
    for n in REQUESTS:
        outs.append(exe(torch.from_numpy(x[off:off + n])))
        off += n
    return torch.cat(outs).numpy()


ORACLE_CASES = [(key, dataflow) for key in sorted(PLAN_CASES)
                for dataflow in (("fused", "bitserial")
                                 if PLAN_CASES[key][4] == "kernels"
                                 else (None,))]


@pytest.mark.parametrize("key,dataflow", ORACLE_CASES,
                         ids=[f"{k}-{d or 'jnp'}" for k, d in ORACLE_CASES])
def test_plan_matches_reference_oracle(key, dataflow):
    """Requests of 1, 3, 8 and 11 images through buckets (1, 8), twice:
    logits equal the reference's spike-plane oracle; the port's own
    oracles agree; the second round builds no plan."""
    jnet, tnet, hw, x, want, backend = _plan_net(key)
    exe = api.Accelerator(backend=backend, dataflow=dataflow,
                          device="cpu").compile(tnet, hw, buckets=BUCKETS)
    np.testing.assert_array_equal(_serve(exe, x), want)
    first = exe.stats()
    np.testing.assert_array_equal(_serve(exe, x), want)
    again = exe.stats()
    assert first["compiles"] == again["compiles"] == len(BUCKETS)
    assert again["executions"] == 2 * first["executions"]
    if backend == "jnp":
        assert again["plane_passes_total"] == 0
        assert again["autotune"]["layers"] == []
    else:
        assert again["plane_passes_total"] > 0
    for mode in ("snn", "packed"):
        np.testing.assert_array_equal(
            api.oracle(tnet, torch.from_numpy(x), mode=mode).numpy(), want)


# one case per spec; the reference's kernels run in interpret mode
REFERENCE_EXE = [("ttfs-avg", "bitserial"), ("phase-8-2-or", "bitserial"),
                 ("rate-avg", None), ("radix-or", None)]


@pytest.mark.parametrize("key,dataflow", REFERENCE_EXE,
                         ids=[k for k, _ in REFERENCE_EXE])
def test_plan_matches_reference_executable(key, dataflow):
    """Six images through bucket 4 (a full chunk and a padded tail) on
    both packages' Executables, same backend and dataflow: logits and
    plane counters equal."""
    jnet, tnet, hw, x, _, backend = _plan_net(key)
    # parallel=1: the tests' 8 host devices (conftest.py) would otherwise
    # shard the reference's bucket over 4 of them, each counting its own
    # planes
    jexe = japi.Accelerator(backend=backend, dataflow=dataflow).compile(
        jnet, hw, buckets=(4,), parallel=1)
    texe = api.Accelerator(backend=backend, dataflow=dataflow,
                           device="cpu").compile(tnet, hw, buckets=(4,))
    np.testing.assert_array_equal(texe(torch.from_numpy(x[:6])).numpy(),
                                  np.asarray(jexe(jnp.asarray(x[:6]))))
    js, ts = jexe.stats(), texe.stats()
    for k in ("plane_passes_skipped", "plane_passes_total", "executions",
              "padded_rows", "compiles"):
        assert ts[k] == js[k], k


@pytest.mark.parametrize("key,dataflow", [("ttfs-avg", "fused"),
                                          ("phase-8-2-or", "bitserial")])
def test_plane_skips_on_sparse_batches_match_reference(key, dataflow):
    """An all-zero batch and a batch with one lit pixel leave planes
    empty: the skip counters are nonzero and equal to the reference's
    (unsharded) kernels plan's, the logits equal."""
    jnet, tnet, hw, _, _, _ = _plan_net(key)
    lit = np.zeros((4,) + hw, np.float32)
    lit[1, hw[0] // 2, hw[1] // 2, 0] = 1.0
    jexe = japi.Accelerator(dataflow=dataflow).compile(
        jnet, hw, buckets=(4,), parallel=1)
    texe = api.Accelerator(dataflow=dataflow, device="cpu").compile(
        tnet, hw, buckets=(4,))
    skipped = []
    for x in (np.zeros((4,) + hw, np.float32), lit):
        np.testing.assert_array_equal(texe(torch.from_numpy(x)).numpy(),
                                      np.asarray(jexe(jnp.asarray(x))))
        js, ts = jexe.stats(), texe.stats()
        assert (ts["plane_passes_skipped"], ts["plane_passes_total"]) == (
            js["plane_passes_skipped"], js["plane_passes_total"])
        skipped.append(ts["plane_passes_skipped"])
    assert 0 < skipped[0] < skipped[1]


@pytest.fixture
def eight_devices(monkeypatch):
    """The port lists 8 CPU devices, mirroring the reference's 8 host
    devices (``tests/conftest.py``)."""
    from repro_torch.core import engine as tengine

    assert jax.device_count() == 8
    monkeypatch.setattr(tengine, "visible_devices",
                        lambda device: [torch.device(device)] * 8)


@pytest.mark.parametrize("key,dataflow", REFERENCE_EXE,
                         ids=[k for k, _ in REFERENCE_EXE])
def test_data_parallel_plan_matches_reference_executable(key, dataflow,
                                                         eight_devices):
    """Both packages at their default ``parallel``: bucket 4 split over
    gcd(4, 8) = 4 devices, each shard with its own occupancy prepass.
    Six images (a chunk and a padded tail), an all-zero batch and a batch
    with one lit pixel: logits and every counter equal the reference's."""
    jnet, tnet, hw, x, _, backend = _plan_net(key)
    jexe = japi.Accelerator(backend=backend, dataflow=dataflow).compile(
        jnet, hw, buckets=(4,))
    texe = api.Accelerator(backend=backend, dataflow=dataflow,
                           device="cpu").compile(tnet, hw, buckets=(4,))
    lit = np.zeros((4,) + hw, np.float32)
    lit[1, hw[0] // 2, hw[1] // 2, 0] = 1.0
    for batch in (x[:6], np.zeros((4,) + hw, np.float32), lit):
        np.testing.assert_array_equal(
            texe(torch.from_numpy(batch)).numpy(),
            np.asarray(jexe(jnp.asarray(batch))))
        js, ts = jexe.stats(), texe.stats()
        for k in ("plane_passes_skipped", "plane_passes_total",
                  "executions", "padded_rows", "compiles"):
            assert ts[k] == js[k], k
    if backend == "kernels":
        assert texe.plan_for(4).data_parallel == 4
        assert ts["plane_passes_skipped"] > 0


def test_data_parallel_errors_match_reference(eight_devices):
    """The plan compiler's ``data_parallel`` checks raise the reference's
    ``ValueError``s, word for word; the bucket cache clamps instead."""
    from repro.core import engine as jengine
    from repro_torch.core import engine as tengine

    jnet, tnet, hw, _, _, _ = _plan_net("ttfs-avg")
    for batch, k in ((6, 4), (16, 16), (4, 0)):
        shape = (batch,) + hw
        with pytest.raises(ValueError) as want:
            jengine._compile_plan_impl(jnet, shape, method="bitserial",
                                       data_parallel=k)
        with pytest.raises(ValueError) as got:
            tengine._compile_plan_impl(tnet, shape, method="bitserial",
                                       data_parallel=k)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jengine.PlanCache(data_parallel=0)
    with pytest.raises(ValueError) as got:
        tengine.PlanCache(data_parallel=0)
    assert str(got.value) == str(want.value)
    cache = tengine.PlanCache((1, 6, 16), data_parallel=16)
    assert [cache._shards_for(b) for b in cache.buckets] == [1, 2, 8]
