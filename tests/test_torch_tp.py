"""Tensor parallelism over 'model' (``parallel/tp.py``): the port's dense
layers split over 4 gloo ranks against the unsharded port and the
reference.

One world of 4 spawned ranks serves the whole module (``_torch_dist``;
its ranks import torch and ``repro_torch`` only).  The reference runs in
this process, on one device and on a mesh of its 8 host devices
((1, 4) and (2, 4) ('data', 'model'), GSPMD partitioning its layers by
the same ``PartitionSpec``s).  The bars:

* a radix product split over 'model', column- or row-parallel (the
  row-parallel int32 accumulators summed over the ranks, the scale a max
  over them), under sequence parallelism too: ``array_equal`` to the
  unsharded product, the port's and the reference's;
* decode attention's partials over each rank's quarter of the slots,
  merged in the kernel's pairwise order: ``array_equal`` to the one-device
  kernel (its plain version here), with ranks whose every slot is masked;
  the reference's oracle at its 3e-5;
* a radix Gemma-2B SMOKE (T = 4, packed KV, packed decode attention)
  over (2, 2) (heads over 'model', the single kv head over head_dim) and
  (1, 4) (head_dim for both): prefill and decode logits ``array_equal`` to
  the unsharded port on each data rank's rows (every product is integer
  and every float op per element, token or head, and each rank's slots
  are whole KV splits of the one-device kernel; the tied head's float
  GEMM over fewer rows rounds otherwise on the CPU, so the data split is
  compared row block by row block); the reference with the same greedy
  tokens at every step and within 2e-2 relative L2 (``radix_attn``
  quantizes the QKV activations too, and a T-bit level at a rounding
  boundary flips between the two packages' float orders: one decode step
  of this seed is 1.4e-2 apart, the others equal;
  ``tests/test_torch_lm_archs.py`` holds the radix FFNs alone at 1e-3);
* float Gemma-2B, RecurrentGemma-2B (the width over 'model', the ring
  cache's slots split), RWKV-6 (heads over (2, 2), each head's key dim
  over (1, 4)) and GLM4-9B (a query head a rank, its 2 kv heads over
  head_dim) SMOKE: the unsharded port and the reference, unsharded and
  on its mesh, at 2e-4 (``tests/test_torch_mesh.py``'s bar: a float
  product split over ranks sums in another order); Whisper SMOKE (the
  encoder over 'model', the cross cache's slots split) against the
  unsharded port at 2e-4;
* 3 sharded adafactor steps (Gemma-2B over (1, 4), RWKV-6 over (1, 4)
  and (2, 2), RecurrentGemma-2B over (1, 4)) against the single-device
  losses at ``test_sharded_train_matches_single_device``'s 5e-4;
* no 'model'-placed parameter and no cache is gathered on the serve path
  (prefill and two decode steps, counted).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_dist
from repro import compat
from repro.configs import get_config as jget
from repro.kernels import ref as jref
from repro.lm import model as jmodel
from repro.lm import radix as jradix
from repro.train import optim as joptim
from repro_torch.configs import get_config as tget
from repro_torch.kernels import radix_attn as ra
from repro_torch.lm import model as tmodel
from repro_torch.lm import radix as tradix
from repro_torch.train import optim as toptim

RADIX = dict(quant="radix", radix_steps=4, radix_kv_pack=True,
             packed_attn=True, radix_attn=True, use_kernel=True,
             kernel_dataflow="fused")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _torch_dist.World(4, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


def _jmesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# Radix products.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kmajor,seq", [(False, False), (True, False),
                                        (True, True)],
                         ids=["q", "kmajor", "kmajor-seq"])
def test_radix_matmul_split_over_model(world, kmajor, seq):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    t = 4
    cfg = _torch_dist._radix_cfg(t)
    wq = tradix.quantize_weight(torch.from_numpy(w))
    want = tradix.maybe_radix_matmul(torch.from_numpy(x), wq, cfg=cfg)
    jcfg = dataclasses.replace(jget("gemma_2b", smoke=True), quant="radix",
                               radix_steps=t)
    jwant = jradix.maybe_radix_matmul(
        jnp.asarray(x), jradix.quantize_weight(jnp.asarray(w)), cfg=jcfg,
        use_kernel=False)
    np.testing.assert_array_equal(want.numpy(), np.asarray(jwant))
    qx, _ = tradix._radix_activation(torch.from_numpy(x), t)
    acc = tradix._int_product(qx, wq["q"]).numpy()
    res = world.run("tp_matmul_case", x, w, t, kmajor, seq)
    np.testing.assert_array_equal(np.concatenate([r[0] for r in res], -1),
                                  want.numpy())
    rows = ([r[1] for r in res] if not seq else
            [np.concatenate([r[1] for r in res], 1)])
    for y in rows:
        np.testing.assert_array_equal(y, want.numpy())
    for r in res:
        np.testing.assert_array_equal(r[2], acc)


# ---------------------------------------------------------------------------
# The cross-rank decode-attention merge.
# ---------------------------------------------------------------------------


def _attn_problem(b, s, hkv, g, hd, t, pos, packed, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv * g, hd)).astype(np.float32)
    lv = rng.integers(0, 1 << t, (2, b, s, hkv, hd)).astype(np.uint8)
    ks, vs = (rng.uniform(0.1, 1.0, (2, b, s, hkv)).astype(np.float32))
    mask = np.broadcast_to(np.arange(s)[None] <= pos, (b, s)).copy()
    stored = lv if not packed else (lv[..., 0::2] << 4) | lv[..., 1::2]
    return (q, stored[0], ks, stored[1], vs, mask), lv


@pytest.mark.parametrize("g,pos,method", [(8, 40, "fused"),
                                          (16, 200, "bitserial"),
                                          (8, 255, "bitserial")],
                         ids=["g8-masked-ranks", "g16", "g8-full"])
def test_attention_merge_across_ranks(world, g, pos, method):
    """Ranks 2 and 3 of the first case hold no valid slot: their splits
    are (MASKED, 0, 0) and add exact zeros."""
    t, packed = 4, True
    args, lv = _attn_problem(2, 256, 1, g, 32, t, pos, packed, g + pos)
    want = ra.radix_decode_attn_plain(*(torch.from_numpy(a) for a in args),
                                      num_steps=t, method=method,
                                      packed=packed)
    for out in world.run("tp_attn_merge_case", args, t, method, packed):
        np.testing.assert_array_equal(out, want.numpy())
    oracle = jref.decode_attn_ref(
        jnp.asarray(args[0]), jnp.asarray(lv[0]), jnp.asarray(args[2]),
        jnp.asarray(lv[1]), jnp.asarray(args[4]), jnp.asarray(args[5]), t)
    np.testing.assert_allclose(want.numpy(), np.asarray(oracle), rtol=3e-5,
                               atol=3e-5)


# ---------------------------------------------------------------------------
# Whole models: prefill and decode.
# ---------------------------------------------------------------------------


def _reference_logits(arch, cfg_kw, tokens, s0, max_len, mesh_shape=None):
    """The reference's prefill and decode logits on the port's seed-0
    weights, on one device or on a mesh of its host devices."""
    jcfg = dataclasses.replace(jget(arch, smoke=True),
                               **{k: v for k, v in cfg_kw.items()
                                  if k != "use_kernel"})
    tcfg = dataclasses.replace(tget(arch, smoke=True), **cfg_kw)
    params = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    jp = jax.tree.map(jnp.asarray, tmodel.tree_map(lambda t: t.numpy(),
                                                   params))
    jp = jmodel.radixify_params(jp, jcfg)
    mesh = None if mesh_shape is None else _jmesh(mesh_shape)
    tok = jnp.asarray(tokens)

    def run():
        pre = jax.jit(lambda p, b: jmodel.prefill(p, b, jcfg, mesh,
                                                  max_len=max_len))
        dec = jax.jit(lambda p, c, t, i: jmodel.decode_step(p, c, t, i, jcfg,
                                                            mesh))
        last, caches = pre(jp, {"tokens": tok[:, :s0 + 1]})
        out = [np.asarray(last)]
        for pos in range(s0, tokens.shape[1]):
            lg, caches = dec(jp, caches, tok[:, pos:pos + 1], jnp.int32(pos))
            out.append(np.asarray(lg))
        return out

    if mesh is None:
        return run()
    with compat.set_mesh(mesh):
        return run()


def _port_logits(arch, cfg_kw, tokens, s0, max_len):
    cfg = dataclasses.replace(tget(arch, smoke=True), **cfg_kw)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg)
    if cfg.quant == "radix":
        params = tmodel.kmajor_params(tmodel.radixify_params(params, cfg))
    tok = torch.from_numpy(tokens)
    last, caches = tmodel.prefill(params, _torch_dist.serve_batch(cfg, tok,
                                                                  s0),
                                  cfg, max_len=max_len)
    out = [last.numpy()]
    for pos in range(s0, tokens.shape[1]):
        lg, caches = tmodel.decode_step(params, caches, tok[:, pos:pos + 1],
                                        pos, cfg)
        out.append(lg.numpy())
    return out


def _tokens(arch, seed, b=4, s=14):
    return np.random.default_rng(seed).integers(
        0, tget(arch, smoke=True).vocab, (b, s)).astype(np.int64)


@pytest.mark.parametrize("shape,placed", [((2, 2), True), ((1, 4), False)],
                         ids=["heads-2x2-placed", "head_dim-1x4"])
def test_radix_gemma_2b_equals_unsharded(world, shape, placed):
    # 128 slots: each rank's are a whole number of the one-device
    # kernel's 32-slot splits, so the merge is its combine
    tokens, s0, max_len = _tokens("gemma_2b", 5), 9, 128
    want = _port_logits("gemma_2b", RADIX, tokens, s0, max_len)
    ref = _reference_logits("gemma_2b", RADIX, tokens, s0, max_len)
    for w, j in zip(want, ref):
        assert _rel(w, j) <= 2e-2
        np.testing.assert_array_equal(w.argmax(-1), j.argmax(-1))
    rows = tokens.shape[0] // shape[0]
    blocks = [_port_logits("gemma_2b", RADIX, tokens[i * rows:(i + 1) * rows],
                           s0, max_len) for i in range(shape[0])]
    want = [np.concatenate(step) for step in zip(*blocks)]
    for got, bad in world.run("tp_serve_case", "gemma_2b", shape, RADIX,
                              tokens, s0, max_len, placed):
        assert not bad, bad
        assert len(got) == len(want)
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"step {step}")


@pytest.mark.parametrize("arch,shape", [
    ("gemma_2b", (1, 4)), ("recurrentgemma_2b", (1, 4)),
    ("rwkv6_3b", (2, 2)), ("rwkv6_3b", (1, 4)), ("glm4_9b", (1, 4)),
    ("whisper_medium", (1, 4))],
    ids=["gemma_2b-1x4", "recurrentgemma_2b-1x4", "rwkv6-heads-2x2",
         "rwkv6-key-1x4", "glm4_9b-kv-head_dim-1x4", "whisper-1x4"])
def test_float_serving_matches_reference(world, arch, shape):
    """Whisper (encoder-decoder: the encoder over 'model' and the
    decoder's cross-attention K/V split over its 16 frames' slots) is held
    against the unsharded port, whose own parity with the reference is
    ``tests/test_torch_lm_encdec.py``'s."""
    tokens, s0 = _tokens(arch, 7), 9
    max_len = 16
    want = _port_logits(arch, {}, tokens, s0, max_len)
    refs = [] if arch == "whisper_medium" else [
        _reference_logits(arch, {}, tokens, s0, max_len),
        _reference_logits(arch, {}, tokens, s0, max_len,
                          shape if shape == (1, 4) else (2, 4))]
    for ref in refs:
        for w, j in zip(want, ref):
            np.testing.assert_allclose(w, j, rtol=2e-4, atol=2e-4)
    for got, bad in world.run("tp_serve_case", arch, shape, {}, tokens, s0,
                              max_len, True):
        assert not bad, bad
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                       err_msg=f"step {step}")


def test_serve_path_gathers_no_model_leaf(world):
    tokens = _tokens("gemma_2b", 9, s=12)
    for counts, placed in world.run("tp_gather_count_case", "gemma_2b",
                                    (2, 2), tokens, 9, 16):
        # the embedding and the seven stacked matrices sit over 'model'
        assert placed == 8, placed
        assert counts == {"sharding.gather": 0, "full_tensor": 0,
                          "redistribute": 0}, counts


def test_kernel_notes_and_collectives_at_local_shapes(world):
    """Under ``launch/op_analysis`` a rank notes its radix products and
    decode attention at its local shapes, a quarter of the unsharded
    work (every product split four ways; each rank attends over a
    quarter of the slots), and the analysis prices the layers'
    collectives (gloo's reduce-scatter is an all-reduce)."""
    tokens, s0, max_len = _tokens("gemma_2b", 11, s=12), 8, 128
    cfg = dataclasses.replace(tget("gemma_2b", smoke=True), **RADIX)
    params = tmodel.kmajor_params(tmodel.radixify_params(
        tmodel.init_params(torch.Generator().manual_seed(0), cfg), cfg))
    want = _torch_dist.radix_serve_notes(cfg, params, tokens, s0, max_len,
                                         None)
    for per, got in world.run("tp_analysis_case", RADIX, tokens, s0,
                              max_len):
        assert per.get("all-gather", 0) > 0 and per.get("all-reduce", 0) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w), (g, w)
            for k in w:
                assert g[k] * 4 == w[k], (k, g[k], w[k])


# ---------------------------------------------------------------------------
# Attention over 'model' where the query heads split head_dim.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,cfg_kw,s0,path,exact", [
    ("gemma_2b", RADIX, 64, "rows", True),
    ("gemma_2b", RADIX, 9, "whole", True),
    ("recurrentgemma_2b", {}, 16, "rows", False),
    ("recurrentgemma_2b", RADIX, 64, "rows", False)],
    ids=["radix-gemma_2b-rows-64", "radix-gemma_2b-whole-9",
         "recurrentgemma_2b-rows-16", "radix-recurrentgemma_2b-rows-64"])
def test_head_dim_attention_path(world, arch, cfg_kw, s0, path, exact):
    """Over (1, 4) the SMOKE archs' 2 query heads split head_dim.  A
    prompt whose length divides 'model' is split over the sequence and
    each rank attends for its own S/4 query rows (64 tokens: 16 a rank,
    one one-device query chunk, so the radix logits stay ``array_equal``
    to the unsharded port); 9 tokens keep every rank on the whole
    path.  RecurrentGemma-2B's local attention (window 8) over rows of
    4 and 16, at the float bar: its RG-LRU block split over 'model' sums
    its float products in another order, radix or not (~1e-6 apart on
    either attention path)."""
    tokens = _tokens(arch, 13, s=s0 + 3)
    max_len = 128
    want = _port_logits(arch, cfg_kw, tokens, s0, max_len)
    cfg = tget(arch, smoke=True)
    n_attn = sum(t in ("attn", "local_attn") for t in cfg.layer_types)
    rows = s0 // 4 if path == "rows" else s0
    other = "whole" if path == "rows" else "rows"
    for got, bad, seen in world.run("tp_rows_serve_case", arch, (1, 4),
                                    cfg_kw, tokens, s0, max_len):
        assert not bad, bad
        assert seen == {path: n_attn * rows, path + "_calls": n_attn,
                        other: 0, other + "_calls": 0}, seen
        for step, (g, w) in enumerate(zip(got, want)):
            if exact:
                np.testing.assert_array_equal(g, w, err_msg=f"step {step}")
            else:
                np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                           err_msg=f"step {step}")


def test_head_dim_attention_share(world):
    """Under ``launch/op_analysis`` at local shapes a rank's scores take
    a quarter of the unsharded prefill's flops, every score call sees
    whole head_dim and this rank's rows only, no q/k/v piece is gathered
    along head_dim by ``gather_from`` (K and V join by ``seq_gather``,
    q by an all-to-all)."""
    s0 = 64
    tokens = _tokens("gemma_2b", 15, s=s0 + 1)
    cfg = tget("gemma_2b", smoke=True)
    for flops, whole, shapes, gathers, per in world.run(
            "tp_rows_share_case", RADIX, tokens, s0):
        assert flops > 0 and flops * 4 == whole, (flops, whole)
        assert sum(s[1] for s in shapes) == cfg.n_layers * s0 // 4, shapes
        assert all(s[2:] == (cfg.n_heads, cfg.hd) for s in shapes), shapes
        assert gathers == 0
        assert per.get("all-to-all", 0) > 0, per


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_2b"])
def test_head_dim_attention_gradients(world, arch):
    """The loss's gradients of ``wq``/``wk``/``wv`` over (1, 4), each
    rank attending for its rows (K/V's gradient the ranks' partial sums
    reduce-scattered, q's the reverse all-to-all), gathered whole: within
    1e-5 relative L2 of the unsharded port's."""
    from repro_torch.train.tree import leaves, leaves_with_paths

    tokens = np.random.default_rng(2).integers(
        0, tget(arch, smoke=True).vocab, (2, 65)).astype(np.int64)
    cfg = dataclasses.replace(tget(arch, smoke=True), seq_shard=True)
    params = tmodel.tree_map(
        lambda t: t.detach().requires_grad_(True),
        tmodel.init_params(torch.Generator().manual_seed(0), cfg))
    loss, _ = tmodel.loss_fn(params, {"tokens": torch.from_numpy(tokens)},
                             cfg)
    grads = torch.autograd.grad(loss, leaves(params))
    loss = float(loss.detach())
    want = {"/".join(str(p) for p in path): g.numpy()
            for (path, _), g in zip(leaves_with_paths(params), grads)
            if str(path[-1]) in ("wq", "wk", "wv") and "mix" in
            [str(p) for p in path]}
    assert want
    for got_loss, got in world.run("tp_attn_grad_case", arch, (1, 4),
                                   tokens):
        assert abs(got_loss - loss) <= 5e-4 * max(1.0, loss)
        assert set(got) == set(want)
        for k, w in want.items():
            assert _rel(got[k], w) <= 1e-5, (k, _rel(got[k], w))


# ---------------------------------------------------------------------------
# The sharded train step.
# ---------------------------------------------------------------------------

LR = 1e-3


def _single_device_loss(arch, tokens, steps):
    jcfg = dataclasses.replace(jget(arch, smoke=True), seq_shard=True)
    tcfg = dataclasses.replace(tget(arch, smoke=True), seq_shard=True)
    params = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    jp = jax.tree.map(jnp.asarray, tmodel.tree_map(lambda t: t.numpy(),
                                                   params))
    jopt, topt = joptim.adafactor(LR), toptim.adafactor(LR)
    st = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jmodel.make_train_step(jcfg, None, jopt))
    ts = {"params": params, "opt": topt.init(params),
          "step": torch.zeros((), dtype=torch.int32)}
    tstep = tmodel.make_train_step(tcfg, topt)
    for _ in range(steps):
        st, jm = jstep(st, {"tokens": jnp.asarray(tokens)})
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(tokens)})
    return float(jm["loss"]), float(tm["loss"])


@pytest.mark.parametrize("arch,shape", [
    ("gemma_2b", (1, 4)), ("rwkv6_3b", (1, 4)), ("rwkv6_3b", (2, 2)),
    ("recurrentgemma_2b", (1, 4))],
    ids=["gemma_2b-1x4", "rwkv6-key-1x4", "rwkv6-heads-2x2",
         "recurrentgemma_2b-1x4"])
def test_tensor_parallel_train_matches_single_device(world, arch, shape):
    tokens = np.random.default_rng(1).integers(
        0, tget(arch, smoke=True).vocab, (8, 17)).astype(np.int64)
    wants = _single_device_loss(arch, tokens, 3)
    for losses, bad in world.run("train_case", arch, shape,
                                 ("data", "model"), tokens, 3, LR):
        assert not bad, bad
        for want in wants:
            assert abs(losses[-1] - want) <= 5e-4 * max(1.0, abs(want)), \
                (losses, wants)
