"""The port's MoE archs (``repro_torch.lm.moe``, Grok-1 and Kimi-K2)
against the JAX package, on the reference's SMOKE configs and its own
weights (``init_params(PRNGKey(0))``, carried across with
``carry.lm_params_from_numpy``).

* ``_router``: the same top-k experts (``array_equal``, ties included:
  ``lax.top_k`` puts the lower expert first) and gates to 1e-5;
  ``moe_ffn`` outputs and aux loss to 1e-5; ``router_aux_loss``;
  mirrors of the reference's ``test_aux_loss_prefers_balance``,
  ``test_radixify_preserves_moe_experts_exact`` and
  ``test_moe_param_counts_match_config``;
* the mesh dispatches (``ep_psum``, ``ep_a2a``, ``tp``) raise
  ``NotImplementedError`` in ``pick_impl``, ``moe_ffn`` and
  ``check_supported``;
* prefill plus 4 decode steps against the reference's at its bar
  (rtol = atol = 2e-4);
* with ``quant="radix"`` (T = 4, packed KV and packed decode attention)
  the port's kernel path (the plain versions on the CPU) against the
  reference's Pallas kernels in interpret mode: 1e-3 relative L2 and the
  same greedy tokens;
* ``LMExecutable`` serving a MoE arch: equal to the port's plain path
  (``torch.equal``) and to the reference's ``LMExecutable`` (1e-3, the
  same greedy tokens).
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
from repro.lm import moe as jmoe
from repro_torch import api as tapi
from repro_torch import carry
from repro_torch.configs import get_config as tget
from repro_torch.lm import model as tmodel
from repro_torch.lm import moe as tmoe
from repro_torch.lm.config import MoEConfig

MOE_ARCHS = ["grok_1_314b", "kimi_k2_1t_a32b"]
B = 2
RADIX = dict(quant="radix", radix_steps=4, radix_kv_pack=True,
             packed_attn=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rtol, f"relative L2 error {err:.3g} > {rtol}"
    return err


_WEIGHTS = {}


def _weights(arch):
    """The reference's SMOKE params (JAX tree, numpy tree), made once."""
    if arch not in _WEIGHTS:
        p = jmodel.init_params(jax.random.PRNGKey(0), jget(arch, smoke=True))
        _WEIGHTS[arch] = (p, jax.tree.map(np.asarray, p))
    return _WEIGHTS[arch]


def _expert_params(seed, d=64, f=96, e=8):
    """The reference's ``tests/test_moe.py`` layer shapes, seeded numpy."""
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(size=(d, e)).astype(np.float32) * 0.1,
            "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) * 0.05,
            "w_up": rng.normal(size=(e, d, f)).astype(np.float32) * 0.05,
            "w_down": rng.normal(size=(e, f, d)).astype(np.float32) * 0.05}


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget(arch, smoke=True), **kw),
            dataclasses.replace(tget(arch, smoke=True), **kw))


# ---------------------------------------------------------------------------
# Router, experts, aux loss.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True], ids=["random", "ties"])
def test_router_matches_reference(tied):
    """Same experts in the same order; with a zero router every
    probability ties and both pick experts 0..k-1."""
    m = MoEConfig(num_experts=8, top_k=3, d_ff_expert=96)
    p = _expert_params(0)
    wr = np.zeros_like(p["router"]) if tied else p["router"]
    x = np.random.default_rng(1).normal(size=(40, 64)).astype(np.float32)
    wg, wi, wp = jmoe._router(_j(x), _j(wr), m)
    gg, gi, gp = tmoe._router(_t(x), _t(wr), m)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gg.numpy(), wg, 1e-5)
    _close(gp.numpy(), wp, 1e-5)
    if tied:
        np.testing.assert_array_equal(gi.numpy(), np.tile([0, 1, 2], (40, 1)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    m = jcfg.moe
    p = _expert_params(2, d=jcfg.d_model, f=m.d_ff_expert, e=m.num_experts)
    x = np.random.default_rng(3).normal(
        size=(B, 7, jcfg.d_model)).astype(np.float32)
    wy, waux = jmoe.moe_ffn(_j(x), jax.tree.map(_j, p), jcfg)
    gy, gaux = tmoe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, tcfg)
    assert tuple(gy.shape) == wy.shape and gy.dtype == torch.float32
    _close(gy.numpy(), wy, 1e-5)
    _close(gaux.numpy(), waux, 1e-5)


def test_router_aux_loss_equals_reference():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 11, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[..., :2]
    want = jmoe.router_aux_loss(_j(probs), _j(idx), 8)
    got = tmoe.router_aux_loss(_t(probs), _t(idx), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_aux_loss_prefers_balance():
    """Mirror of the reference's test: balanced routing scores lower."""
    probs_bal = torch.full((64, 4), 0.25)
    idx_bal = torch.stack([torch.arange(64) % 4,
                           (torch.arange(64) + 1) % 4], -1)
    probs_skew = torch.tensor([[0.97, 0.01, 0.01, 0.01]]).repeat(64, 1)
    idx_skew = torch.zeros((64, 2), dtype=torch.long)
    bal = tmoe.router_aux_loss(probs_bal, idx_bal, 4)
    skew = tmoe.router_aux_loss(probs_skew, idx_skew, 4)
    assert float(bal) < float(skew)


def test_radixify_preserves_moe_experts_exact():
    """Mirror of the reference's test: routed experts stay exact, the
    shared expert and the attention stay as the reference leaves them,
    and the MoE family's unembed stays exact too."""
    cfg = dataclasses.replace(tget("kimi_k2_1t_a32b", smoke=True),
                              quant="radix")
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg)
    q = tmodel.radixify_params(params, cfg)
    ffn = q["segments"][0][0]["ffn"]
    assert torch.is_tensor(ffn["w_gate"])               # experts stay exact
    assert torch.is_tensor(ffn["router"])
    assert isinstance(ffn["shared"]["w_gate"], dict)    # shared quantized
    assert torch.is_tensor(q["unembed"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_counts_match_config(arch):
    """Mirror of the reference's test, on the port's configs."""
    cfg = tget(arch)
    total, active = cfg.params_total(), cfg.params_active()
    assert active < total
    if arch == "kimi_k2_1t_a32b":
        assert 0.8e12 < total < 1.3e12, total       # ~1T
        assert 20e9 < active < 45e9, active         # ~32B active
    else:
        assert 250e9 < total < 370e9, total         # ~314B
    assert (total, active) == (jget(arch).params_total(),
                               jget(arch).params_active())


@pytest.mark.parametrize("impl", ["ep_psum", "ep_a2a", "tp"])
def test_mesh_dispatch_raises(impl):
    cfg = tget("kimi_k2_1t_a32b", smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl=impl))
    p = {k: _t(v) for k, v in _expert_params(5, d=cfg.d_model,
                                             f=cfg.moe.d_ff_expert).items()}
    # the mesh dispatches are ported (tests/test_torch_mesh.py): the config
    # is admitted, and naming one without a mesh raises ValueError where
    # the reference fails on its own: an AttributeError on mesh.shape
    # (ep_*), or shard_map's ValueError for an empty mesh (tp)
    tmodel.check_supported(cfg)
    for call in (lambda: tmoe.pick_impl(cfg),
                 lambda: tmoe.moe_ffn(torch.zeros((1, 2, cfg.d_model)), p,
                                      cfg)):
        with pytest.raises(ValueError, match="mesh"):
            call()
    jcfg = dataclasses.replace(jget("kimi_k2_1t_a32b", smoke=True),
                               moe=dataclasses.replace(
                                   jget("kimi_k2_1t_a32b", smoke=True).moe,
                                   impl=impl))
    with pytest.raises(AttributeError if impl != "tp" else ValueError):
        jmoe.moe_ffn(jnp.zeros((1, 2, cfg.d_model)),
                     {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                     jcfg, None)
    auto = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl="auto"))
    assert tmoe.pick_impl(auto) == "ref" == jmoe.pick_impl(auto, None, False)


# ---------------------------------------------------------------------------
# Whole models.
# ---------------------------------------------------------------------------


def _serve_pair(arch, jcfg, tcfg, tokens, s0, feed, max_len):
    """Prefill ``tokens[:, :s0]`` and decode what ``feed(pos, port logits,
    reference logits)`` returns ((B, 1) tokens, None to stop) on both
    sides; yields (step, port logits, reference logits)."""
    jparams, nparams = _weights(arch)
    tparams = carry.lm_params_from_numpy(nparams, tcfg)
    jparams = jmodel.radixify_params(jparams, jcfg)
    tparams = tmodel.kmajor_params(tmodel.radixify_params(tparams, tcfg))
    jl, jc = jmodel.prefill(jparams, {"tokens": _j(tokens[:, :s0 + 1])},
                            jcfg, None, max_len=max_len)
    tl, tc = tmodel.prefill(tparams, {"tokens": _t(tokens[:, :s0 + 1])},
                            tcfg, max_len=max_len)
    yield 0, tl, jl
    for i, pos in enumerate(range(s0, max_len)):
        tok = feed(pos, tl, jl)
        if tok is None:
            return
        jl, jc = jmodel.decode_step(jparams, jc, _j(tok).astype(jnp.int32),
                                    jnp.int32(pos), jcfg, None)
        tl, tc = tmodel.decode_step(tparams, tc, _t(tok).long(), pos, tcfg)
        yield i + 1, tl, jl


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    tokens = np.random.default_rng(12).integers(0, jcfg.vocab, size=(B, 17))
    s0 = 12

    def feed(pos, tl, jl):
        return tokens[:, pos:pos + 1] if pos < s0 + 4 else None

    steps = 0
    for step, tl, jl in _serve_pair(arch, jcfg, tcfg, tokens, s0, feed, 20):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4, err_msg=f"step {step}")
        steps += 1
    assert steps == 5


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_radix_serving_matches_reference_kernels(arch):
    """T = 4 radix weights (Kimi's shared expert; the routed experts and
    the unembed stay exact), packed KV and packed decode attention, fused
    dataflow: the port's kernel path on the CPU against the reference's
    Pallas kernels in interpret mode, greedy."""
    jcfg, tcfg = _cfgs(arch, use_kernel=True, kernel_dataflow="fused",
                       **RADIX)
    tokens = np.random.default_rng(13).integers(0, jcfg.vocab, size=(B, 12))
    s0 = 11

    def feed(pos, tl, jl):
        return np.asarray(jl).argmax(-1)[:, None] if pos < s0 + 4 else None

    for step, tl, jl in _serve_pair(arch, jcfg, tcfg, tokens, s0, feed, 16):
        err = _close(tl.numpy(), jl, 1e-3)
        np.testing.assert_array_equal(
            tl.numpy().argmax(-1), np.asarray(jl).argmax(-1),
            err_msg=f"step {step}: greedy tokens (rel L2 {err:.3g})")
    assert step == 4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_executable_serves_moe(arch):
    """A MoE SMOKE arch through both packages' ``Accelerator.compile`` at
    (2, 24), buckets (8, 16), fused: every step equal to the port's plain
    path and within 1e-3 of the reference's executable, greedy equal."""
    jparams, nparams = _weights(arch)
    kw = dict(radix_steps=4, radix_kv_pack=True, packed_attn=True)
    jcfg, tcfg = _cfgs(arch, **kw)
    exe_j = japi.Accelerator(backend="kernels", dataflow="fused").compile(
        (jparams, jcfg), (2, 24), buckets=(8, 16))
    exe_t = tapi.Accelerator(dataflow="fused", device="cpu").compile(
        (carry.lm_params_from_numpy(nparams, tcfg), tcfg), (2, 24),
        buckets=(8, 16))
    plain = dataclasses.replace(exe_t.cfg, use_kernel=False)
    prompts = np.random.default_rng(14).integers(0, tcfg.vocab, size=(2, 11))
    padded = torch.zeros((2, 17), dtype=torch.long)
    padded[:, :11] = _t(prompts)
    pl, pc = tmodel.prefill(exe_t.params, {"tokens": padded}, plain,
                            max_len=24, true_len=11)
    sj = exe_j.prefill(jnp.asarray(prompts, jnp.int32))
    st = exe_t.prefill(prompts)
    for step in range(4):
        assert torch.equal(st["logits"], pl), f"step {step}"
        _close(st["logits"].numpy(), sj["logits"], 1e-3)
        tok = np.asarray(sj["logits"]).argmax(-1)
        np.testing.assert_array_equal(st["logits"].numpy().argmax(-1), tok)
        sj = exe_j.decode(sj, jnp.asarray(tok[:, None], jnp.int32))
        st = exe_t.decode(st, tok[:, None])
        pl, pc = tmodel.decode_step(exe_t.params, pc, _t(tok[:, None]),
                                    11 + step, plain)
    assert exe_t.stats()["compiles"] == exe_j.stats()["compiles"] == 2
