"""The port's launch-parameter autotuner (``repro_torch.kernels.autotune``)
against the reference tuner's contract (``tests/test_autotune.py``).

What carries over: the winner cache (hit/miss/disk counters, a versioned
JSON table, a corrupt file as a cold cache, the environment variable),
key anatomy (a key that dropped the dataflow or the encoding schedule
would alias distinct problems), the untuned default as the first
candidate, the exactness guard, and deterministic winner selection
under an injectable timer.  What is the port's own: the candidates are
launch parameters of the hand-written kernels (tile, split-K, KV split),
never the plain version on a CUDA tensor; split-K gives the same
integers at every split (``gemm.emulate``); and a tuned CPU plan's
logits equal the reference's kernels ``Executable``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import conversion as jconv
from repro.kernels import ref as jref
from repro.models import lenet as jlenet
from repro_torch import api, carry
from repro_torch.core import encoding
from repro_torch.kernels import autotune as at
from repro_torch.kernels import gemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import radix_attn as tra
from repro_torch.kernels.autotune import (AutotuneCache, KernelConfig,
                                          attn_candidates, conv_candidates,
                                          conv_key, exact_lowering,
                                          matmul_candidates, matmul_key, tune)

T = 4


def _sched(T=4, periods=1, out_grid="dense"):
    return encoding.KernelSchedule(packed_bits=T, periods=periods,
                                   out_grid=out_grid)


@pytest.fixture
def fresh_cache(monkeypatch, tmp_path):
    """A process table with its disk table under ``tmp_path``."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    at.reset_default_cache()
    yield at.default_cache()
    at.reset_default_cache()


# ---------------------------------------------------------------------------
# KernelConfig and the exactness guard.
# ---------------------------------------------------------------------------


def test_config_roundtrip():
    cfg = KernelConfig(bm=32, bn=128, bk=128, split=4, split_slots=64,
                       max_splits=16)
    assert KernelConfig.from_dict(cfg.as_dict()) == cfg
    assert KernelConfig.from_dict(json.loads(json.dumps(cfg.as_dict()))) \
        == cfg


@pytest.mark.parametrize("fields", [
    dict(impl="xla"), dict(impl="pallas"), dict(bm=64, bn=64, bk=64),
    dict(bm=128), dict(split=-1), dict(split_slots=48),
    dict(split_slots=0), dict(max_splits=64), dict(max_splits=0)])
def test_config_validates(fields):
    with pytest.raises(ValueError):
        KernelConfig(**fields)


@pytest.mark.parametrize("mnk", [(8, 2048, 16384), (8, 16384, 2048),
                                 (2048, 16384, 2048), (401408, 64, 27),
                                 (1, 100, 4096), (100, 40, 500)])
def test_default_is_the_untuned_launch(mnk):
    """``KernelConfig()`` launches exactly what ``gemm.plan`` picks, and
    splits attention by the module's constants."""
    m, n, k = mnk
    cfg = KernelConfig()
    assert cfg.impl == "cuda" and cfg.tile is None and cfg.split == 0
    assert cfg.launch(m, n, k, 132) == gemm.plan(m, n, k, 132)
    assert cfg.splits == (tra.SPLIT_SLOTS, tra.MAX_SPLITS)


def test_named_tile_and_split_launch():
    cfg = KernelConfig(bm=128, bn=64, bk=64, split=4)
    launch = cfg.launch(1000, 300, 1024, 132)
    assert launch.tile is gemm.MID and launch.split == 4
    # a split past K's tiles comes out at K's tiles, none empty
    launch = KernelConfig(bm=32, bn=128, bk=128, split=8).launch(8, 64, 200,
                                                                 132)
    assert launch.split == 2
    assert all(hi > lo for lo, hi in gemm.k_ranges(200, launch))


def test_exactness_guard():
    """u8 x s8 -> s32 is exact while operand * 127 * K < 2^31: a plane bit
    bitserial, the level fused, at most a byte (carries go as byte
    groups)."""
    assert exact_lowering(max_operand=1, k_contract=1 << 20,
                          method="bitserial")
    assert exact_lowering(max_operand=255, k_contract=66000, method="fused")
    assert not exact_lowering(max_operand=255, k_contract=66312,
                              method="fused")
    assert exact_lowering(max_operand=1023, k_contract=66000,
                          method="fused")        # byte groups of a carry
    assert exact_lowering(max_operand=15, k_contract=1 << 20,
                          method="fused")
    with pytest.raises(ValueError):
        exact_lowering(max_operand=1, k_contract=1, method="rowwise")


def test_guard_filters_the_candidates():
    """Past the bound only the untuned launch is offered; bitserial at the
    same K still sweeps."""
    wide = matmul_candidates(64, 1 << 17, 64, _sched(T=8), "fused",
                             backend="cuda")
    assert wide == [KernelConfig()]
    bits = matmul_candidates(64, 1 << 17, 64, _sched(T=8), "bitserial",
                             backend="cuda")
    assert len(bits) > 1


# ---------------------------------------------------------------------------
# Keys.
# ---------------------------------------------------------------------------


def test_key_dataflow_separates():
    a = matmul_key(8, 16, 8, _sched(), "fused", epilogue=False,
                   sparsity=False, backend="cpu")
    b = matmul_key(8, 16, 8, _sched(), "bitserial", epilogue=False,
                   sparsity=False, backend="cpu")
    assert a != b


def test_key_schedule_separates():
    kw = dict(epilogue=False, sparsity=False, backend="cpu")
    radix = matmul_key(8, 16, 8, _sched(T=4), "bitserial", **kw)
    phase = matmul_key(8, 16, 8, _sched(T=4, periods=2), "bitserial", **kw)
    assert radix != phase


def test_key_out_grid_separates_only_with_epilogue():
    kw = dict(sparsity=False, backend="cpu")
    dense = matmul_key(8, 16, 8, _sched(out_grid="dense"), "fused",
                       epilogue=True, **kw)
    pow2 = matmul_key(8, 16, 8, _sched(out_grid="pow2"), "fused",
                      epilogue=True, **kw)
    assert dense != pow2
    assert matmul_key(8, 16, 8, _sched(out_grid="dense"), "fused",
                      epilogue=False, **kw) == matmul_key(
        8, 16, 8, _sched(out_grid="pow2"), "fused", epilogue=False, **kw)


def test_key_epilogue_sparsity_shape_backend_separate():
    base = dict(epilogue=False, sparsity=False, backend="cpu")
    k0 = matmul_key(8, 16, 8, _sched(), "fused", **base)
    assert k0 != matmul_key(8, 16, 8, _sched(), "fused", epilogue=True,
                            sparsity=False, backend="cpu")
    assert k0 != matmul_key(8, 16, 8, _sched(), "fused", epilogue=False,
                            sparsity=True, backend="cpu")
    assert k0 != matmul_key(16, 16, 8, _sched(), "fused", **base)
    assert k0 != matmul_key(8, 16, 8, _sched(), "fused", epilogue=False,
                            sparsity=False, backend="cuda")
    # the backend is the tensors' device type
    assert matmul_key(8, 16, 8, _sched(), "fused", epilogue=False,
                      sparsity=False, backend=torch.device("cuda", 0))[1] \
        == "cuda"


def test_conv_key_includes_geometry():
    kw = dict(batch=2, epilogue=False, sparsity=False, backend="cpu")
    a = conv_key(8, 8, 3, 3, 3, 16, 1, _sched(), "fused", **kw)
    assert a != conv_key(8, 8, 3, 3, 3, 16, 2, _sched(), "fused", **kw)
    assert a != conv_key(8, 8, 3, 5, 5, 16, 1, _sched(), "fused", **kw)
    assert a != conv_key(8, 8, 3, 3, 3, 16, 1, _sched(), "fused",
                         **dict(kw, batch=8))


def test_attn_key_fields():
    kw = dict(q_bits=7, packed=True, sparsity=True, backend="cuda")
    a = at.attn_key(8, 512, 1, 8, 256, 4, "fused", **kw)
    assert a != at.attn_key(8, 512, 2, 16, 128, 4, "fused", **kw)
    assert a != at.attn_key(8, 512, 1, 8, 256, 4, "bitserial", **kw)
    assert a != at.attn_key(8, 512, 1, 8, 256, 4, "fused",
                            **dict(kw, packed=False))


def test_forced_collision_is_the_same_problem():
    a = matmul_key(8, 16, 8, _sched(), "fused", epilogue=True,
                   sparsity=True, backend="cpu")
    b = matmul_key(8, 16, 8, 4, "fused", epilogue=True, sparsity=True,
                   backend="cpu")
    assert a == b


# ---------------------------------------------------------------------------
# Candidates.
# ---------------------------------------------------------------------------

# (M, K, N) of the main paths' GEMMs: Gemma-2B decode and prefill FFN,
# VGG-11's linear layers at bucket 8, ragged shapes
_MATMULS = [(8, 2048, 16384), (8, 16384, 2048), (2048, 2048, 16384),
            (512, 16384, 2048), (8, 25088, 4096), (8, 4096, 100),
            (1, 333, 70), (40, 333, 70), (100, 500, 40)]
# (batch, h, w, cin, kh, kw, cout, stride): VGG-11 at 224, bucket 8,
# pre-padded; LeNet-5; a strided conv
_CONVS = [(8, 226, 226, 3, 3, 3, 64, 1), (8, 16, 16, 512, 3, 3, 512, 1),
          (1, 16, 16, 512, 3, 3, 512, 1), (8, 32, 32, 1, 5, 5, 6, 1),
          (2, 17, 19, 32, 3, 3, 48, 2)]


def _all_cuda_candidates():
    out = []
    for method in ("fused", "bitserial"):
        for steps in (4, 8, 10):
            for m, k, n in _MATMULS:
                out.append(matmul_candidates(m, k, n, _sched(T=steps),
                                             method, backend="cuda"))
            for b, h, w, cin, kh, kw, cout, s in _CONVS:
                out.append(conv_candidates(h, w, cin, kh, kw, cout, s,
                                           _sched(T=steps), method, batch=b,
                                           backend="cuda"))
    for s_len in (1, 33, 300, 512, 4096, 8192):
        out.append(attn_candidates(s_len, backend="cuda"))
    return out


def test_first_candidate_is_the_default():
    for cands in _all_cuda_candidates():
        assert cands[0] == KernelConfig()


def test_no_plain_candidate_on_cuda():
    """The plain versions are for tests: a tuned plan on the card runs
    kernel launches only."""
    for cands in _all_cuda_candidates():
        assert cands and all(c.impl == "cuda" for c in cands)


def test_no_duplicates():
    for cands in _all_cuda_candidates():
        assert len(cands) == len(set(cands))


def test_gemm_candidates_fit_the_shape():
    for m, k, n in _MATMULS:
        cands = matmul_candidates(m, k, n, _sched(), "fused", backend="cuda")
        for c in cands[1:]:
            assert c.tile is not None
            assert c.split <= max(1, -(-k // c.bk))
            if m <= gemm.SMALL_M:
                assert c.tile is gemm.SMALL
        # gemm.plan's own launch is offered once, as the default
        heuristic = gemm.tile_for(m, n)
        assert KernelConfig(bm=heuristic.act, bn=heuristic.w,
                            bk=heuristic.bk) not in cands
    big = matmul_candidates(2048, 2048, 16384, _sched(), "fused",
                            backend="cuda")
    assert {c.tile for c in big[1:]} == set(gemm.TILES)


def test_candidates_given_the_card_are_distinct_launches():
    """With the card's SM count, no two candidates launch the same tile
    and split (e.g. the heuristic tile at split 1 where ``gemm.plan``
    splits nothing), and none is lost that launches something new."""
    for m, k, n in _MATMULS:
        for method in ("fused", "bitserial"):
            every = matmul_candidates(m, k, n, _sched(), method,
                                      backend="cuda")
            cands = matmul_candidates(m, k, n, _sched(), method,
                                      backend="cuda", sms=132)
            launches = [c.launch(m, n, k, 132) for c in cands]
            assert cands[0] == KernelConfig()
            assert len(set(launches)) == len(launches)
            assert set(cands) <= set(every)
            assert {c.launch(m, n, k, 132) for c in every} == set(launches)
    # VGG-11's first layer at bucket 8: gemm.plan splits nothing there, so
    # its tile at split 1 is the default's launch and is not offered again
    b, h, w, cin, kh, kw, cout, st = _CONVS[0]
    m = b * (h - kh + 1) * (w - kw + 1)
    heuristic = gemm.tile_for(m, cout)
    assert gemm.plan(m, cout, kh * kw * cin, 132).split == 1
    cands = conv_candidates(h, w, cin, kh, kw, cout, st, _sched(), "fused",
                            batch=b, backend="cuda", sms=132)
    assert KernelConfig(bm=heuristic.act, bn=heuristic.w, bk=heuristic.bk,
                        split=1) not in cands
    assert len(cands) > 1


def test_attn_candidates_are_distinct_splits():
    for s_len in (1, 33, 300, 512, 4096, 8192):
        cands = attn_candidates(s_len, backend="cuda")
        sizes = [tra.split_slots(s_len, *c.splits) for c in cands]
        cuts = [size if size < s_len else None for size in sizes]
        assert len(cuts) == len(set(cuts))
        assert all(-(-s_len // size) <= tra.KERNEL_MAX_SPLITS
                   for size in sizes)
    assert len(attn_candidates(1, backend="cuda")) == 1
    assert len(attn_candidates(512, backend="cuda")) > 1


def test_cpu_candidate_is_the_plain_version():
    plain = [KernelConfig(impl="plain")]
    assert matmul_candidates(8, 16, 8, _sched(), "fused",
                             backend="cpu") == plain
    assert conv_candidates(8, 8, 3, 3, 3, 16, 1, _sched(), "bitserial",
                           batch=2, backend="cpu") == plain
    assert attn_candidates(512, backend="cpu") == plain


# ---------------------------------------------------------------------------
# Split-K and the KV split.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["fused", "bitserial"])
@pytest.mark.parametrize("wide", [False, True])
def test_split_k_gives_the_same_integers(method, wide):
    """``gemm.emulate`` (the launch's arithmetic) at every tile and split
    the tuner offers equals the reference product: int32 sums do not
    depend on how K is cut."""
    rng = np.random.default_rng(11)
    m, k, n = 8, 700, 24
    bits = 10 if wide else 8
    x = rng.integers(0, 1 << bits, (m, k)).astype(
        np.int32 if wide else np.uint8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    want = np.asarray(jref.radix_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                            bits))
    xt, wk = torch.from_numpy(x), gemm.matmul_kmajor(torch.from_numpy(w))
    cands = matmul_candidates(m, k, n, bits, method, backend="cuda")
    assert len(cands) > 3
    for cfg in cands:
        launch = cfg.launch(m, n, k, 132)
        got = gemm.emulate(xt, wk, num_steps=bits, fused=method == "fused",
                           launch=launch)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(cfg))


def test_split_slots_rule():
    assert tra.split_slots(512) == 32
    assert tra.split_slots(512, 64, 32) == 64
    assert tra.split_slots(8192, 32, 16) == 512
    assert tra.split_slots(8192, 64, 16) == 512
    assert tra.split_slots(1000, 64, 16) == 64
    with pytest.raises(ValueError):
        tra.split_slots(512, 40, 32)
    with pytest.raises(ValueError):
        tra.split_slots(512, 32, 33)


# ---------------------------------------------------------------------------
# The cache.
# ---------------------------------------------------------------------------


def test_cache_hit_miss_counters():
    cache = AutotuneCache(None)
    key = ("matmul", "cuda", 1)
    assert cache.get(key) is None
    assert cache.stats.misses == 1
    cache.put(key, KernelConfig(split=2), 12.5)
    assert cache.get(key) == KernelConfig(split=2)
    assert cache.stats.hits == 1 and cache.stats.disk_hits == 0


def test_cache_disk_roundtrip(tmp_path):
    path = tmp_path / "autotune.json"
    a = AutotuneCache(path)
    key = matmul_key(8, 16, 8, _sched(), "fused", epilogue=False,
                     sparsity=False, backend="cuda")
    cfg = KernelConfig(bm=32, bn=128, bk=128, split=4)
    a.put(key, cfg, 3.0)
    b = AutotuneCache(path)                 # a second process
    assert b.get(key) == cfg
    assert b.stats.disk_hits == 1 and b.stats.hits == 1
    payload = json.loads(path.read_text())
    assert payload["version"] == 1 and len(payload["entries"]) == 1


@pytest.mark.parametrize("text", ["{not json", "[]", '{"entries": 3}',
                                  '{"entries": {"k": {"config": '
                                  '{"impl": "pallas"}}}}'])
def test_corrupt_disk_table_is_cold_cache(tmp_path, text):
    path = tmp_path / "autotune.json"
    path.write_text(text)
    cache = AutotuneCache(path)
    key = ("matmul", "cuda", 2)
    assert cache.get(key) is None           # no raise
    cache.put(key, KernelConfig(), 1.0)     # and the file heals
    assert json.loads(path.read_text())["version"] == 1


def test_env_var(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "")
    assert at.cache_path() is None
    at.reset_default_cache()
    try:
        assert at.default_cache().path is None   # empty: no persistence
    finally:
        at.reset_default_cache()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    assert at.cache_path() == tmp_path / "t.json"
    # the reference's variable is not read: its records have other fields
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    assert at.cache_path() == (at.pathlib.Path.home() / ".cache"
                               / "repro_torch" / "autotune.json")


# ---------------------------------------------------------------------------
# The tuning loop.
# ---------------------------------------------------------------------------

_CANDS = [KernelConfig(), KernelConfig(bm=32, bn=128, bk=128, split=2),
          KernelConfig(bm=128, bn=64, bk=64, split=4)]


def _name(cfg):
    return f"{cfg.bm}/{cfg.split}"


def test_deterministic_winner_under_fake_timer():
    cache = AutotuneCache(None)
    times = {"0/0": 30.0, "32/2": 10.0, "128/4": 20.0}
    seen = []
    win = tune(("k", 1), _CANDS, lambda cfg: (lambda: _name(cfg)),
               cache=cache, timer=lambda thunk: times[thunk()],
               on_result=lambda cfg, us: seen.append((_name(cfg), us)))
    assert win == _CANDS[1]
    assert cache.stats.sweeps == 1 and cache.stats.skipped == 0
    assert seen == [("0/0", 30.0), ("32/2", 10.0), ("128/4", 20.0)]


def test_tie_breaks_by_candidate_order():
    cache = AutotuneCache(None)
    win = tune(("k", 2), _CANDS, lambda cfg: (lambda: None), cache=cache,
               timer=lambda thunk: 7.0)
    assert win == KernelConfig()


def test_failing_candidates_skipped_and_counted():
    cache = AutotuneCache(None)

    def build(cfg):
        if cfg.split == 2:
            raise RuntimeError("launch refused")
        return lambda: _name(cfg)

    win = tune(("k", 3), _CANDS, build, cache=cache,
               timer=lambda thunk: {"0/0": 5.0, "128/4": 2.0}[thunk()])
    assert win == _CANDS[2]
    assert cache.stats.skipped == 1


def test_all_failing_raises():
    cache = AutotuneCache(None)
    with pytest.raises(RuntimeError):
        tune(("k", 4), _CANDS,
             lambda cfg: (_ for _ in ()).throw(RuntimeError()),
             cache=cache, timer=lambda thunk: 1.0)
    assert cache.stats.skipped == len(_CANDS)
    with pytest.raises(ValueError):
        tune(("k", 5), [], lambda cfg: None, cache=cache)


def test_second_call_hits_never_resweeps():
    cache = AutotuneCache(None)
    calls = []

    def timer(thunk):
        calls.append(1)
        return 1.0

    for _ in range(3):
        tune(("k", 6), _CANDS, lambda cfg: (lambda: None), cache=cache,
             timer=timer)
    assert cache.stats.sweeps == 1
    assert len(calls) == len(_CANDS)
    assert cache.stats.hits == 2


def test_distinct_keys_sweep_separately():
    cache = AutotuneCache(None)
    kw = dict(epilogue=False, sparsity=False, backend="cuda")
    kf = matmul_key(8, 16, 8, _sched(), "fused", **kw)
    kb = matmul_key(8, 16, 8, _sched(), "bitserial", **kw)
    tune(kf, _CANDS, lambda cfg: (lambda: None), cache=cache,
         timer=lambda t: 1.0)
    tune(kb, [_CANDS[2]], lambda cfg: (lambda: None), cache=cache,
         timer=lambda t: 1.0)
    assert cache.stats.sweeps == 2
    assert cache.get(kf) == KernelConfig()
    assert cache.get(kb) == _CANDS[2]


def test_measure_on_the_host_clock():
    """A thunk that returns no CUDA tensor is timed by the host clock."""
    us = at.measure(lambda: torch.ones(4).sum(), iters=3)
    assert 0.0 < us < 1e6


# ---------------------------------------------------------------------------
# End to end on the CPU.
# ---------------------------------------------------------------------------


def test_ops_autotune_exact_and_cached(fresh_cache):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 16, (8, 24), dtype=np.uint8)
    w = rng.integers(-8, 8, (24, 8)).astype(np.int8)
    want = np.asarray(jref.radix_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                            4))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(tops.radix_matmul(xt, wt, None, 4).numpy(),
                                  want)
    np.testing.assert_array_equal(
        tops.radix_matmul(xt, wt, None, 4, autotune=True).numpy(), want)
    assert fresh_cache.stats.sweeps == 1
    np.testing.assert_array_equal(
        tops.radix_matmul(xt, wt, None, 4, autotune=True).numpy(), want)
    assert fresh_cache.stats.sweeps == 1 and fresh_cache.stats.hits >= 1
    # the conv: the same contract
    xc = torch.from_numpy(rng.integers(0, 16, (2, 6, 6, 3), dtype=np.uint8))
    wc = torch.from_numpy(rng.integers(-8, 8, (3, 3, 3, 5)).astype(np.int8))
    base = tops.radix_conv2d(xc, wc, None, 4, padding="SAME")
    assert torch.equal(tops.radix_conv2d(xc, wc, None, 4, padding="SAME",
                                         autotune=True), base)
    assert fresh_cache.stats.sweeps == 2
    assert len(fresh_cache) == 2 and fresh_cache.path.exists()


@pytest.fixture(scope="module")
def lenet():
    static, params, hw = jlenet.make(jax.random.PRNGKey(5), pool_mode="avg",
                                     width_mult=0.25)
    calib = np.random.default_rng(17).uniform(0, 1, (8,) + hw).astype(
        np.float32)
    jnet = jconv.convert(static, params, jnp.asarray(calib), num_steps=T)
    tnet = carry.qnet_from_numpy(
        jnet.static,
        [None if qp is None else {k: None if qp[k] is None
                                  else np.asarray(qp[k])
                                  for k in ("w_q", "b_int", "mult")}
         for qp in jnet.qlayers],
        num_steps=T, weight_bits=jnet.weight_bits,
        input_scale=jnet.input_scale, logit_scale=jnet.logit_scale)
    x = np.random.default_rng(23).uniform(0, 1, (6,) + hw).astype(np.float32)
    return jnet, tnet, hw, x


@pytest.mark.parametrize("dataflow", ["fused", "bitserial"])
def test_tuned_cpu_plan_equals_reference_executable(lenet, fresh_cache,
                                                    dataflow):
    """A tuned CPU plan (every layer's one candidate, the plain version)
    gives the reference kernels ``Executable``'s logits; a second compile
    sweeps nothing."""
    jnet, tnet, hw, x = lenet
    acc = api.Accelerator(dataflow=dataflow, device="cpu")
    exe = acc.compile(tnet, hw, buckets=(4,), autotune=True)
    got = exe(torch.from_numpy(x)).numpy()
    jexe = japi.Accelerator(dataflow=dataflow).compile(jnet, hw, buckets=(4,))
    np.testing.assert_array_equal(got, np.asarray(jexe(jnp.asarray(x))))
    stats = exe.stats()["autotune"]
    layers = stats["layers"]
    n_kernel = sum(kind in ("conv", "linear") for kind, _ in tnet.static)
    assert stats["enabled"] and len(layers) == n_kernel
    assert all(r["tuned"] and r["impl"] == "plain" and len(r["sweep"]) == 1
               for r in layers)
    sweeps = fresh_cache.stats.sweeps
    assert sweeps == n_kernel and fresh_cache.stats.skipped == 0
    again = acc.compile(tnet, hw, buckets=(4,), autotune=True)
    np.testing.assert_array_equal(again(torch.from_numpy(x)).numpy(), got)
    assert fresh_cache.stats.sweeps == sweeps
    assert all("sweep" not in r for r in again.stats()["autotune"]["layers"])
    untuned = acc.compile(tnet, hw, buckets=(4,))
    np.testing.assert_array_equal(untuned(torch.from_numpy(x)).numpy(), got)
    assert not untuned.stats()["autotune"]["enabled"]
