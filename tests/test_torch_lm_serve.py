"""The port's LM serving path (``Accelerator.compile((params, cfg), ...)``
-> ``LMExecutable``) against the reference's, end to end.

Both packages serve the reference's Gemma-2B SMOKE weights
(``init_params(PRNGKey(0))``, carried across as numpy), T = 4, with
``radix_kv_pack`` on, ``packed_attn`` on and off and both dataflows, at
batch 2, ``max_len`` 24 and sequence buckets (8, 16): the reference on its
kernels backend (Pallas in interpret mode), the port on ``device="cpu"``
(the kernels' plain versions).  A prefill of 11 tokens and 4 decode steps
must give logits within 1e-3 relative L2 at every step and the same
greedy tokens, equal plan-cache counters, and no plan built after
``warmup``.  The compile-time rejections (a recurrent block, an
encoder-decoder or embedding-input arch among them) carry the
reference's messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_config as jget
from repro.lm import model as jmodel
from repro_torch import api as tapi
from repro_torch import carry
from repro_torch.configs import get_config as tget

COUNTERS = ("compiles", "hits", "executions", "padded_rows")


@pytest.fixture(scope="module")
def weights():
    params = jmodel.init_params(jax.random.PRNGKey(0),
                                jget("gemma_2b", smoke=True))
    return params, jax.tree.map(np.asarray, params)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("packed_attn", [False, True])
@pytest.mark.parametrize("dataflow", ["fused", "bitserial"])
def test_lm_executable_matches_reference(weights, packed_attn, dataflow):
    jparams, nparams = weights
    kw = dict(radix_steps=4, radix_kv_pack=True, packed_attn=packed_attn)
    jcfg = dataclasses.replace(jget("gemma_2b", smoke=True), **kw)
    tcfg = dataclasses.replace(tget("gemma_2b", smoke=True), **kw)
    exe_j = japi.Accelerator(backend="kernels", dataflow=dataflow).compile(
        (jparams, jcfg), (2, 24), buckets=(8, 16)).warmup()
    exe_t = tapi.Accelerator(dataflow=dataflow, device="cpu").compile(
        (carry.lm_params_from_numpy(nparams, tcfg), tcfg), (2, 24),
        buckets=(8, 16)).warmup()
    built = exe_t.stats()["compiles"]
    assert built == exe_j.stats()["compiles"] == 3   # 2 buckets + decode

    prompts = np.random.default_rng(1).integers(0, tcfg.vocab, size=(2, 11))
    sj = exe_j.prefill(jnp.asarray(prompts, jnp.int32))
    st = exe_t.prefill(prompts)
    for step in range(5):
        lj, lt = np.asarray(sj["logits"]), st["logits"].numpy()
        assert lt.shape == lj.shape == (2, tcfg.vocab)
        err = _rel_l2(lt, lj)
        assert err <= 1e-3, f"step {step}: logits relative L2 {err:.3g}"
        tok = lj.argmax(-1)
        np.testing.assert_array_equal(lt.argmax(-1), tok)
        if step < 4:
            sj = exe_j.decode(sj, jnp.asarray(tok[:, None], jnp.int32))
            st = exe_t.decode(st, tok[:, None])
    assert st["pos"] == sj["pos"] == 15
    stats_j, stats_t = exe_j.stats(), exe_t.stats()
    assert {k: stats_t[k] for k in COUNTERS} == \
        {k: stats_j[k] for k in COUNTERS}
    assert stats_t["compiles"] == built            # zero steady-state builds


def test_generate_greedy_and_sampled(weights):
    _, nparams = weights
    cfg = dataclasses.replace(tget("gemma_2b", smoke=True),
                              radix_kv_pack=True, packed_attn=True)
    exe = tapi.Accelerator(device="cpu").compile(
        (carry.lm_params_from_numpy(nparams, cfg), cfg), (2, 24),
        buckets=(8, 16))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 6))
    greedy = exe.generate(prompts, 3)
    assert tuple(greedy.shape) == (2, 3) and greedy.dtype == torch.long
    state = exe.prefill(prompts)
    assert torch.equal(greedy[:, 0], state["logits"].argmax(-1))
    draws = [exe.generate(prompts, 3, greedy=False,
                          generator=torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])          # seeded: reproducible
    with pytest.raises(ValueError, match="generator="):
        exe.generate(prompts, 3, greedy=False)
    with pytest.raises(ValueError, match="exceed the compiled cache"):
        exe.generate(prompts, 20)


REJECTIONS = [
    # compile kwargs (or a prefill shape), the reference's message
    (dict(input_spec=(2, 24), auto="throughput"), "auto"),
    (dict(input_spec=(2, 24), encoding="rate"), "radix encoding"),
    (dict(input_spec=(2, 16), buckets=(8, 16)), "free decode slot"),
    (dict(prefill=(2, 17)), "exceeds the top sequence bucket"),
    (dict(prefill=(3, 8)), "exceeds compiled batch"),
    (dict(input_spec=(2, 24), cfg=dict(block_pattern=("attn", "rglru"))),
     "full-attention"),
    (dict(input_spec=(2, 24), cfg=dict(encoder_layers=2, encoder_ctx=16)),
     "encoder-decoder and embedding-input archs run"),
    (dict(input_spec=(2, 24), cfg=dict(embedding_inputs=True)),
     "token-in/token-out decoder stacks"),
]


@pytest.mark.parametrize("case,match", REJECTIONS,
                         ids=[m for _, m in REJECTIONS])
def test_lm_compile_rejects_like_reference(weights, case, match):
    jparams, nparams = weights
    case = dict(case)
    prefill = case.pop("prefill", None)
    fields = case.pop("cfg", {})
    spec = case.pop("input_spec", (2, 24))
    jcfg = dataclasses.replace(jget("gemma_2b", smoke=True), **fields)
    tcfg = dataclasses.replace(tget("gemma_2b", smoke=True), **fields)
    tparams = carry.lm_params_from_numpy(
        nparams, tget("gemma_2b", smoke=True))
    sides = [
        (japi.Accelerator(backend="kernels", dataflow="bitserial"), jparams,
         jcfg, lambda s: jnp.zeros(s, jnp.int32)),
        (tapi.Accelerator(dataflow="bitserial", device="cpu"), tparams,
         tcfg, lambda s: torch.zeros(s, dtype=torch.long)),
    ]
    for acc, params, cfg, zeros in sides:
        with pytest.raises(ValueError, match=match):
            if prefill is None:
                acc.compile((params, cfg), spec, **case)
            else:
                exe = acc.compile((params, cfg), spec, buckets=(8, 16))
                exe.prefill(zeros(prefill))
