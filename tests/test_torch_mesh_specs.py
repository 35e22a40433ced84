"""The port's sharding rules against the reference's, with no ranks.

The rules are pure functions of leaf paths, shapes, the config and the
mesh's axis sizes, so the port's are given ``{axis: size}`` mappings and
the reference's its ``Mesh`` over the 8 host devices
(``tests/conftest.py``).  For every leaf of all ten archs (SMOKE), on
meshes (2, 4), (4, 2), (1, 8) ('data', 'model') and (2, 2, 2) ('pod',
'data', 'model'): ``param_specs``, ``cache_specs`` (batch 8, max_len
32), ``batch_specs`` (``seq_shard`` on and off), ``opt_state_specs``
(adafactor, adam) and ``zero_upgrade`` equal the reference's
``PartitionSpec``s entry for entry.  Also the MoE capacity dispatch and
``pick_impl``'s rules, which need no ranks either.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import LM_ARCHS, get_config as jget
from repro.lm import model as jmodel
from repro.lm import moe as jmoe
from repro.parallel import sharding as JSH
from repro.parallel.zero import zero_upgrade as jzero
from repro.train import optim as joptim
from repro_torch.configs import get_config as tget
from repro_torch.lm import model as tmodel
from repro_torch.lm import moe as tmoe
from repro_torch.parallel import sharding as TSH
from repro_torch.parallel.zero import zero_upgrade as tzero
from repro_torch.train import optim as toptim
from repro_torch.train.tree import leaves_with_paths

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _jpath(path) -> tuple:
    out = []
    for p in path:
        if hasattr(p, "key"):
            out.append(str(p.key))
        elif hasattr(p, "idx"):
            out.append(int(p.idx))
        else:
            out.append(str(p.name))
    return tuple(out)


def _jflat(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {_jpath(path): tuple(spec) for path, spec in flat}


def _at(tree, path):
    for p in path:
        tree = tree[p] if isinstance(tree, dict) or isinstance(p, int) \
            else getattr(tree, p)
    return tree


def _tflat(specs, like) -> dict:
    return {path: _at(specs, path) for path, _ in leaves_with_paths(like)}


def _meta(tree):
    return tmodel.tree_map(lambda t: torch.empty(
        tuple(t.shape), device="meta"), tree)


_ABSTRACT = {}


def _abstract(arch):
    """(reference abstract params, cache, batch; port's), per arch."""
    if arch not in _ABSTRACT:
        jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
        jparams = jmodel.abstract_params(jcfg)
        tparams = tmodel.init_params(torch.Generator().manual_seed(0), tcfg,
                                     device="meta")
        jcache = jmodel.abstract_cache(jcfg, batch=8, max_len=32)
        tcache = _meta(tmodel.init_cache(tcfg, 8, 32, device="cpu"))
        if tcfg.embedding_inputs:
            shapes = {"embeds": (8, 16, tcfg.d_model), "labels": (8, 16)}
        else:
            shapes = {"tokens": (8, 17)}
        if tcfg.encoder_layers:
            shapes["enc_embeds"] = (8, tcfg.encoder_ctx, tcfg.d_model)
        jbatch = {k: jax.ShapeDtypeStruct(v, jnp.float32)
                  for k, v in shapes.items()}
        tbatch = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
        _ABSTRACT[arch] = (jcfg, tcfg, jparams, tparams, jcache, tcache,
                           jbatch, tbatch)
    return _ABSTRACT[arch]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_specs_match_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh = compat.make_mesh(shape, axes)
    sizes = dict(zip(axes, shape))
    (jcfg, tcfg, jparams, tparams, jcache, tcache, jbatch,
     tbatch) = _abstract(arch)

    jp = JSH.param_specs(jparams, jcfg, jmesh)
    tp = TSH.param_specs(tparams, tcfg, sizes)
    assert _tflat(tp, tparams) == _jflat(jp)
    assert (_tflat(tzero(tp, tparams, sizes), tparams)
            == _jflat(jzero(jp, jparams, jmesh)))
    assert (_tflat(TSH.cache_specs(tcache, tcfg, sizes), tcache)
            == _jflat(JSH.cache_specs(jcache, jcfg, jmesh)))
    for seq_shard in (True, False):
        assert (_tflat(TSH.batch_specs(tbatch, tcfg, sizes, seq_shard),
                       tbatch)
                == _jflat(JSH.batch_specs(jbatch, jcfg, jmesh, seq_shard)))
    for jopt, topt in ((joptim.adafactor(1e-3), toptim.adafactor(1e-3)),
                       (joptim.adam(1e-3), toptim.adam(1e-3))):
        jo = jax.eval_shape(jopt.init, jparams)
        to = topt.init(tparams)
        want = _jflat(JSH.opt_state_specs(jp, jo, jmesh))
        assert _tflat(TSH.opt_state_specs(tp, to, sizes), to) == want


def test_zero_upgrade_and_batch_specs_cases():
    """The reference's own cases (``tests/test_sharding.py``) on (2, 4):
    a replicated (64, 32) leaf gains a data axis, a (3,) one does not;
    Qwen2-VL's embeds and labels shard their batch dim."""
    sizes = {"data": 2, "model": 4}
    tree = {"big": torch.empty((64, 32), device="meta"),
            "tiny": torch.empty((3,), device="meta")}
    up = tzero({"big": (None, None), "tiny": (None,)}, tree, sizes)
    assert up == {"big": ("data", None), "tiny": (None,)}
    cfg = tget("qwen2_vl_72b", smoke=True)
    specs = TSH.batch_specs(
        {"embeds": torch.empty((8, 16, cfg.d_model), device="meta"),
         "labels": torch.empty((8, 16), device="meta")}, cfg, sizes)
    assert specs["embeds"][0] == "data" and specs["labels"][0] == "data"


def test_placements_round_trip():
    """A spec's placements name its dims per mesh axis, and back."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = {"pod": 2, "data": 2, "model": 2}
    spec = (("pod", "data"), None, "model")
    pls = TSH.placements(spec, sizes)
    assert pls == (Shard(0), Shard(0), Shard(2))
    assert TSH.spec_from(pls, sizes) == spec
    assert TSH.placements((None,), sizes) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        TSH.placements((("data", "pod"),), sizes)
    x = np.arange(8 * 3 * 4).reshape(8, 3, 4)
    got = TSH.local_slice(x, spec, sizes, {"pod": 1, "data": 0, "model": 1})
    np.testing.assert_array_equal(got, x[4:6, :, 2:4])


# ---------------------------------------------------------------------------
# MoE: capacity dispatch and the dispatch rules.
# ---------------------------------------------------------------------------


def _route(n=24, e=8, k=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((n, d)).astype(np.float32)
    wr = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    m = dataclasses.replace(jget("kimi_k2_1t_a32b", smoke=True).moe,
                            num_experts=e, top_k=k)
    gates, idx, _ = tmoe._router(torch.from_numpy(x2), torch.from_numpy(wr),
                                 m)
    return x2, idx.numpy(), gates.numpy()


@pytest.mark.parametrize("e_lo,e_hi,cap", [(0, 8, 64), (0, 8, 3), (2, 6, 2),
                                           (4, 8, 1)],
                         ids=["generous", "drops", "middle", "last-cap1"])
def test_dispatch_and_combine_match_reference(e_lo, e_hi, cap):
    """Slots equal; buffers and the combined output equal, with drops."""
    x2, idx, gates = _route()
    jbuf, jmeta = jmoe._dispatch(jnp.asarray(x2), jnp.asarray(idx, jnp.int32),
                                 jnp.asarray(gates), e_lo, e_hi, cap)
    tbuf, tmeta = tmoe._dispatch(torch.from_numpy(x2), torch.from_numpy(idx),
                                 torch.from_numpy(gates), e_lo, e_hi, cap)
    for j, t in zip(jmeta, tmeta):
        assert np.array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    if cap < 64:
        assert not bool(tmeta[2].all())           # something dropped
    y = np.random.default_rng(1).standard_normal(
        tbuf.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tmoe._combine(torch.from_numpy(y), tmeta, x2.shape[0]).numpy(),
        np.asarray(jmoe._combine(jnp.asarray(y), jmeta, x2.shape[0])))


def _moe_cfg(num_experts, impl="auto"):
    cfg = tget("kimi_k2_1t_a32b", smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=num_experts, impl=impl))


def test_pick_impl_rules():
    """``tests/test_moe.py``'s rules on (2, 4), and a named mesh dispatch
    without a mesh raises ``ValueError`` (the reference fails there with
    an ``AttributeError``)."""
    mesh = {"data": 2, "model": 4}
    jmesh = compat.make_mesh((2, 4), ("data", "model"))
    big, small = _moe_cfg(8), _moe_cfg(6)
    for cfg, decode, want in ((big, False, "ep_a2a"), (big, True, "ep_psum"),
                              (small, False, "tp")):
        assert tmoe.pick_impl(cfg, mesh, decode=decode) == want
        jcfg = dataclasses.replace(jget("kimi_k2_1t_a32b", smoke=True),
                                   moe=dataclasses.replace(
                                       jget("kimi_k2_1t_a32b",
                                            smoke=True).moe,
                                       num_experts=cfg.moe.num_experts))
        assert jmoe.pick_impl(jcfg, jmesh, decode) == want
    assert tmoe.pick_impl(big, None, decode=False) == "ref"
    assert tmoe.pick_impl(big, {"data": 8, "model": 1}) == "ref"
    for impl in ("ep_psum", "ep_a2a", "tp"):
        with pytest.raises(ValueError, match="mesh"):
            tmoe.pick_impl(_moe_cfg(8, impl), None)
