"""Rank side of the port's multi-rank tests (not collected: no ``test_``
prefix).  Imports torch and ``repro_torch`` only.

:class:`World` spawns ``size`` processes (the ``spawn`` start method) that
join one gloo process group through a ``FileStore`` (a file, so no port
is fixed and parallel test workers cannot collide) and then serve tasks:
``world.run(name, *args)`` calls the function ``name`` of this module on
every rank with ``args`` and returns the ranks' results, in rank order.
Results travel back pickled, so the functions return numpy arrays and
plain Python values.  A rank that raises fails the call with its
traceback; a call that outlives its timeout fails with ``TimeoutError``.
Either way the world is torn down and the next call starts a new one.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import time
import traceback

import numpy as np
import torch

_START_S = 120.0


class World:
    def __init__(self, size: int, store_dir: str, timeout: float = 180.0):
        self.size, self.store_dir, self.timeout = size, store_dir, timeout
        self._procs, self._in, self._starts = [], [], 0
        self._fresh = False

    def _start(self):
        ctx = mp.get_context("spawn")
        self._starts += 1
        store = os.path.join(self.store_dir, f"store{self._starts}")
        self._in = [ctx.Queue() for _ in range(self.size)]
        self._out = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, self.size, store, self._in[r], self._out))
            for r in range(self.size)]
        for p in self._procs:
            p.start()
        self._fresh = True

    def run(self, name: str, *args, timeout: float = None):
        if not self._procs:
            self._start()
        for q in self._in:
            q.put((name, args))
        deadline = time.monotonic() + (timeout or self.timeout) + (
            _START_S if self._fresh else 0.0)
        results = [None] * self.size
        try:
            for _ in range(self.size):
                try:
                    rank, ok, value = self._out.get(
                        timeout=max(deadline - time.monotonic(), 0.1))
                except queue.Empty:
                    raise TimeoutError(f"{name}: no answer from every rank "
                                       "in time") from None
                if not ok:
                    raise RuntimeError(f"{name} failed on rank {rank}:\n"
                                       f"{value}")
                results[rank] = value
        except BaseException:
            self.close()
            raise
        self._fresh = False
        return results

    def close(self):
        for q in self._in:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._procs, self._in = [], []


def _rank_main(rank, size, store_path, inbox, outbox):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=120))
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            name, args = task
            try:
                outbox.put((rank, True, globals()[name](*args)))
            except BaseException:
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Helpers.
# ---------------------------------------------------------------------------


def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes)


def _np(t):
    return t.detach().to(torch.float32).numpy() if torch.is_tensor(t) else t


def _local_shapes_ok(tree, specs, mesh) -> list:
    """Leaves whose local piece is not the slice their spec gives."""
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.tree import leaves_with_paths

    bad = []
    for path, leaf in leaves_with_paths(tree):
        spec = specs
        for p in path:
            spec = spec[p] if isinstance(spec, dict) or isinstance(p, int) \
                else getattr(spec, p)
        want = tuple(SH.local_slice(torch.empty(tuple(leaf.shape),
                                                device="meta"), spec,
                                    mesh).shape)
        if tuple(leaf.to_local().shape) != want or SH.spec_of(leaf) != \
                tuple(spec) + (None,) * (leaf.ndim - len(spec)):
            bad.append((path, tuple(leaf.to_local().shape), want))
    return bad


def moe_cfg(num_experts, top_k, d, f, cf, impl):
    from repro_torch.configs import get_config
    from repro_torch.lm.config import MoEConfig

    return dataclasses.replace(
        get_config("kimi_k2_1t_a32b", smoke=True), d_model=d,
        moe=MoEConfig(num_experts=num_experts, top_k=top_k, d_ff_expert=f,
                      capacity_factor=cf, impl=impl))


# ---------------------------------------------------------------------------
# Tasks (each runs on every rank).
# ---------------------------------------------------------------------------


def moe_case(shape, cfg_kw, p_np, x_np, loss=None):
    """``moe_ffn`` of this data rank's rows on a ('data', 'model') mesh:
    (data rank, local y, aux, {leaf: gradient}) with the gradients of
    ``loss``: "both" sum(y^2) + 0.01 aux, "y2" sum(y^2), "aux" aux, None
    none."""
    from repro_torch.lm import moe

    mesh = _mesh(shape)
    cfg = moe_cfg(**cfg_kw)
    p = {k: torch.from_numpy(v).requires_grad_(loss is not None)
         for k, v in p_np.items()}
    d = mesh.get_local_rank("data")
    rows = x_np.shape[0] // shape[0]
    x = torch.from_numpy(x_np[d * rows:(d + 1) * rows])
    y, aux = moe.moe_ffn(x, p, cfg, mesh)
    g = {}
    if loss is not None:
        objective = {"both": lambda: torch.sum(y ** 2) + 0.01 * aux,
                     "y2": lambda: torch.sum(y ** 2), "aux": lambda: aux}
        objective[loss]().backward()
        g = {k: np.zeros(v.shape, np.float32) if v.grad is None
             else _np(v.grad) for k, v in p.items()}
    return d, _np(y), float(aux), g


def _train_setup(arch, shape, axes, seq_shard, capacity):
    from repro_torch.configs import get_config
    from repro_torch.lm import model as M

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              seq_shard=seq_shard)
    if cfg.moe is not None and capacity:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    mesh = _mesh(shape, axes)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, mesh, params


def _place_state(cfg, opt, params, mesh):
    from repro_torch.parallel import sharding as SH

    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    pspecs = SH.param_specs(params, cfg, mesh)
    specs = {"params": pspecs,
             "opt": SH.opt_state_specs(pspecs, state["opt"], mesh),
             "step": ()}
    return SH.place(state, specs, mesh), specs


def train_case(arch, shape, axes, tokens, steps, lr):
    """``steps`` adafactor steps of the sharded train step: (losses,
    leaves whose local piece is not their spec's slice)."""
    from repro_torch.lm import model as M
    from repro_torch.train import optim

    cfg, mesh, params = _train_setup(arch, shape, axes, True, 8.0)
    opt = optim.adafactor(lr)
    state, specs = _place_state(cfg, opt, params, mesh)
    step = M.make_train_step(cfg, opt, mesh=mesh)
    losses = []
    for _ in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(m["loss"]))
    return losses, _local_shapes_ok(state, specs, mesh)


def decode_case(arch, shape, tokens, s0, max_len):
    """Prefill of ``tokens[:, :s0 + 1]`` and one decode step of its last
    token at position s0, over the mesh: (prefill logits, decode logits,
    cache leaves whose piece is not their spec's slice)."""
    from repro_torch.configs import get_config
    from repro_torch.lm import model as M
    from repro_torch.parallel import sharding as SH

    cfg = get_config(arch, smoke=True)
    mesh = _mesh(shape)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.from_numpy(tokens)
    last, caches = M.prefill(params, {"tokens": tok[:, :s0 + 1]}, cfg, mesh,
                             max_len=max_len)
    specs = SH.cache_specs(caches, cfg, mesh)
    bad = _local_shapes_ok(caches, specs, mesh)
    logits, caches = M.decode_step(params, caches, tok[:, s0:s0 + 1], s0,
                                   cfg, mesh)
    return _np(last), _np(logits), bad


def reshard_case(ckpt_dir, w_np):
    """``w`` saved from a (2, 2) mesh as ('data', 'model'); restored onto
    (4, 1) as ('model', 'data') and onto (1, 4) as (('data', 'model'),
    None): each rank's piece equals its slice of ``w``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import sharding as SH
    from repro_torch.train import checkpoint as ckpt

    mesh = _mesh((2, 2))
    w = torch.from_numpy(w_np)
    ckpt.save(ckpt_dir, 1, {"w": SH.place(w, ("data", "model"), mesh)})
    torch.distributed.barrier()
    ok = []
    for shape, spec in (((4, 1), ("model", "data")),
                        ((1, 4), (("data", "model"), None))):
        m = _mesh(shape)
        got, _ = ckpt.restore_resharded(
            ckpt_dir, 1, {"w": torch.empty(w.shape, device="meta")},
            {"w": SH.placements(spec, m)}, m)
        ok.append(isinstance(got["w"], DTensor) and torch.equal(
            got["w"].to_local(), SH.local_slice(w, spec, m)))
        ok.append(torch.equal(got["w"].full_tensor(), w))
    return ok


def reference_ckpt_case(ckpt_dir, leaves, specs):
    """A checkpoint the reference wrote (``leaves``: key -> (global numpy
    array, dtype name), bf16 as uint16 bits) restored resharded on a
    (2, 2) mesh by ``specs``: each rank's piece equals its slice."""
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import checkpoint as ckpt

    mesh = _mesh((2, 2))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int32": torch.int32}
    shapes = {k: torch.empty(a.shape, dtype=dtypes[dt], device="meta")
              for k, (a, dt) in leaves.items()}
    got, extra = ckpt.restore_resharded(
        ckpt_dir, 3, shapes, {k: SH.placements(s, mesh)
                              for k, s in specs.items()}, mesh)
    ok = {}
    for k, (a, dt) in leaves.items():
        want = torch.from_numpy(a)
        if dt == "bfloat16":
            want = want.view(torch.int16).view(torch.bfloat16)
        local = got[k].to_local()
        piece = SH.local_slice(want, specs[k], mesh)
        ok[k] = (local.dtype == want.dtype and torch.equal(
            local.view(torch.int16) if dt == "bfloat16" else local,
            piece.view(torch.int16) if dt == "bfloat16" else piece))
    return ok, extra


def elastic_case(ckpt_dir, tokens, lr):
    """GLM4-9B SMOKE: 4 steps on (2, 2) against 2 steps on (2, 2), a
    checkpoint, ``reshard_checkpoint`` onto (4, 1) and 2 more steps:
    (uninterrupted losses, elastic losses, restored pieces equal)."""
    from repro_torch.lm import model as M
    from repro_torch.parallel import sharding as SH
    from repro_torch.runtime import elastic
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optim
    from repro_torch.train.tree import leaves

    cfg, mesh_a, params = _train_setup("glm4_9b", (2, 2),
                                       ("data", "model"), True, 0)
    opt = optim.adafactor(lr)
    batch = {"tokens": torch.from_numpy(tokens)}
    step_a = M.make_train_step(cfg, opt, mesh=mesh_a)
    st, _ = _place_state(cfg, opt, params, mesh_a)
    ref = []
    for _ in range(4):
        st, m = step_a(st, batch)
        ref.append(float(m["loss"]))
    st, _ = _place_state(cfg, opt, params, mesh_a)
    el = []
    for _ in range(2):
        st, m = step_a(st, batch)
        el.append(float(m["loss"]))
    ckpt.save(ckpt_dir, 2, st, extra={"mesh": [2, 2]})
    torch.distributed.barrier()
    whole = SH.gather(st)
    mesh_b = _mesh((4, 1))
    restored, extra = elastic.reshard_checkpoint(ckpt_dir, 2, cfg, opt,
                                                 mesh_b)
    same = all(torch.equal(a.full_tensor(), b)
               for a, b in zip(leaves(restored), leaves(whole)))
    step_b = M.make_train_step(cfg, opt, mesh=mesh_b)
    for _ in range(2):
        restored, m = step_b(restored, batch)
        el.append(float(m["loss"]))
    return ref, el, same and extra == {"mesh": [2, 2]}


def loader_case(world: int):
    """``ShardedLoader`` over a ('data',) mesh of every rank, through the
    ``Prefetcher``: (steps seen, local shapes, global shapes, rows equal
    to this rank's slice)."""
    from repro_torch.data import Prefetcher, ShardedLoader, synthetic_tokens

    mesh = _mesh((world,), ("data",))
    loader = ShardedLoader(lambda s: (synthetic_tokens(s, 8, 16, 128),),
                           mesh, [("data", None)])
    seen, local, glob, rows = [], [], [], []
    k = mesh.get_local_rank("data")
    for s, (tok,) in Prefetcher(loader, start_step=3, num_steps=4, depth=2):
        seen.append(s)
        local.append(tuple(tok.to_local().shape))
        glob.append(tuple(tok.shape))
        n = 8 // world
        rows.append(np.array_equal(tok.to_local().numpy(),
                                   synthetic_tokens(s, 8, 16, 128)[
                                       k * n:(k + 1) * n]))
    return seen, local, glob, rows


def train_main_case(ckpt_dir, argv):
    """``launch.train.main(argv)`` over the world: (losses, the state's
    step, the checkpoint's newest step)."""
    from repro_torch.launch import train
    from repro_torch.train import checkpoint as ckpt

    state, losses = train.main(argv + ["--ckpt-dir", ckpt_dir])
    return losses, int(state["step"].full_tensor()), ckpt.latest_step(
        ckpt_dir)


def _pipe_block(lp, x):
    return torch.tanh(x @ lp["w"] + lp["b"])


def _pipe_seq(params, x):
    """Every layer on each microbatch in turn, one microbatch at a time."""
    outs = []
    for xm in x:
        for j in range(params["w"].shape[0]):
            xm = _pipe_block({"w": params["w"][j], "b": params["b"][j]}, xm)
        outs.append(xm)
    return torch.stack(outs)


def gpipe_case(shape, p_np, x_np, placed: bool):
    """``gpipe`` over the 'pod' axis of a ('pod', 'data') mesh of
    ``shape``, its stacked params whole or (``placed``) DTensors placed
    ``Shard(0)`` on 'pod': (output, sequential loop's output, output
    ``torch.equal`` to it, gradients of sum(out^2), the sequential
    loop's gradients)."""
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.pipeline import gpipe

    mesh = _mesh(shape, ("pod", "data"))
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p_np.items()}
    x = torch.from_numpy(x_np)
    stacked = ({k: SH.place(v, ("pod",), mesh) for k, v in params.items()}
               if placed else params)
    out = gpipe(_pipe_block, mesh, axis="pod")(stacked, x)
    grads = torch.autograd.grad(torch.sum(out ** 2), list(stacked.values()))
    grads = [g.full_tensor() if placed else g for g in grads]
    ref = _pipe_seq(params, x)
    ref_g = torch.autograd.grad(torch.sum(ref ** 2), list(params.values()))
    return (_np(out), _np(ref), torch.equal(out, ref),
            {k: _np(g) for k, g in zip(params, grads)},
            {k: _np(g) for k, g in zip(params, ref_g)})


# ---------------------------------------------------------------------------
# Tensor parallelism over 'model' (``parallel/tp.py``).
# ---------------------------------------------------------------------------


def _radix_cfg(t: int, **kw):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("gemma_2b", smoke=True),
                               quant="radix", radix_steps=t, use_kernel=True,
                               **kw)


def tp_matmul_case(x_np, w_np, t, kmajor, seq):
    """A radix product on a (1, 4) mesh, column- and row-parallel: (this
    rank's output columns, the row-parallel output (this rank's tokens
    under ``seq``), the row-parallel int32 accumulator summed over the
    ranks)."""
    from repro_torch.lm import radix
    from repro_torch.parallel.tp import TP

    mesh = _mesh((1, 4))
    cfg = _radix_cfg(t)
    tp = TP(mesh, {}).with_seq(seq)
    n, r = tp.n, tp.rank
    x = torch.from_numpy(x_np)
    w = radix.quantize_weight(torch.from_numpy(w_np))
    k_r, n_r = x.shape[-1] // n, w["q"].shape[-1] // n
    cols = slice(r * n_r, (r + 1) * n_r)
    rows = slice(r * k_r, (r + 1) * k_r)
    w_col = {"q": w["q"][:, cols].contiguous(), "scale": w["scale"][cols]}
    w_row = {"q": w["q"][rows].contiguous(), "scale": w["scale"]}
    if kmajor:
        w_col, w_row = radix.kmajor_weight(w_col), radix.kmajor_weight(w_row)
    y_col = radix.maybe_radix_matmul(x, w_col, cfg=cfg)
    y_row = radix.maybe_radix_matmul(x[..., rows], w_row, cfg=cfg, tp=tp)
    qx, _ = radix._radix_activation(x[..., rows], t, tp)
    acc = tp.sum_int(radix._int_product(qx, w["q"][rows]))
    return _np(y_col), _np(y_row), acc.numpy()


def tp_attn_merge_case(args, t, method, packed):
    """Decode attention over this rank's quarter of the slots in the
    partials mode, the ranks' partials all-gathered and merged: the
    output (B, H, hd)."""
    from repro_torch.kernels import radix_attn as ra
    from repro_torch.parallel import collectives as C

    mesh = _mesh((1, 4))
    q, kq, ks, vq, vs, mask = (torch.from_numpy(a) for a in args)
    n, r = 4, mesh.get_local_rank("model")
    s_loc = kq.shape[1] // n
    sl = slice(r * s_loc, (r + 1) * s_loc)
    b, h, hd = q.shape
    hkv = kq.shape[2]
    split = ra.split_slots(kq.shape[1])
    out = torch.full((ra.partials_size(b * hkv, -(-s_loc // split),
                                       h // hkv, hd),), float("nan"))
    part = ra.radix_decode_attn_cuda(
        q, kq[:, sl], ks[:, sl], vq[:, sl], vs[:, sl], mask[:, sl],
        num_steps=t, method=method, packed=packed, partials=True,
        splits=(split, ra.MAX_SPLITS), out=out)
    assert part is out
    parts = C.gather_from(part[None], 0, mesh, ("model",)).unbind(0)
    out = ra.merge_partials(parts, b * hkv, h // hkv, hd).reshape(b, h, hd)
    return out.numpy()


def _serve_params(cfg, mesh, placed):
    from repro_torch.lm import model as M
    from repro_torch.parallel import sharding as SH

    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    if cfg.quant == "radix":
        params = M.kmajor_params(M.radixify_params(params, cfg))
    if placed:
        params = SH.place(params, SH.param_specs(params, cfg, mesh), mesh)
    return params


def serve_batch(cfg, tok, s0):
    """The prefill batch of ``tok[:, :s0 + 1]``; an encoder-decoder's
    frame embeddings drawn from seed 0."""
    batch = {"tokens": tok[:, :s0 + 1]}
    if cfg.encoder_layers:
        batch["enc_embeds"] = torch.randn(
            (tok.shape[0], cfg.encoder_ctx, cfg.d_model),
            generator=torch.Generator().manual_seed(0))
    return batch


def tp_serve_case(arch, shape, cfg_kw, tokens, s0, max_len, placed):
    """Prefill of ``tokens[:, :s0 + 1]`` and decode of the next tokens of
    ``tokens`` up to ``max_len`` over a ('data', 'model') mesh: every
    step's logits (the prefill's first), and the cache leaves whose local
    piece is not their spec's slice."""
    from repro_torch.configs import get_config
    from repro_torch.lm import model as M
    from repro_torch.parallel import sharding as SH

    cfg = dataclasses.replace(get_config(arch, smoke=True), **cfg_kw)
    mesh = _mesh(shape)
    params = _serve_params(cfg, mesh, placed)
    tok = torch.from_numpy(tokens)
    last, caches = M.prefill(params, serve_batch(cfg, tok, s0), cfg, mesh,
                             max_len=max_len)
    bad = _local_shapes_ok(caches, SH.cache_specs(caches, cfg, mesh), mesh)
    out = [_np(last)]
    for pos in range(s0, tokens.shape[1]):
        logits, caches = M.decode_step(params, caches, tok[:, pos:pos + 1],
                                       pos, cfg, mesh)
        out.append(_np(logits))
    return out, bad


def tp_gather_count_case(arch, shape, tokens, s0, max_len):
    """Prefill and two decode steps over the mesh with parameters placed
    by ``param_specs``, counting the gathers of a leaf split over 'model':
    ``sharding.gather`` calls, ``full_tensor`` and ``redistribute`` calls
    that join a 'model' split.  Returns the counts and the radix/float
    parameter leaves placed over 'model'."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.lm import model as M
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.tree import leaves

    cfg = get_config(arch, smoke=True)
    mesh = _mesh(shape)
    params = _serve_params(cfg, mesh, True)
    model_dim = list(SH.axis_sizes(mesh)).index("model")
    counts = {"sharding.gather": 0, "full_tensor": 0, "redistribute": 0}

    def over_model(dt):
        return dt.placements[model_dim].is_shard()

    orig = (SH.gather, DTensor.full_tensor, DTensor.redistribute)

    def gather(tree):
        counts["sharding.gather"] += 1
        return orig[0](tree)

    def full_tensor(self, *a, **k):
        counts["full_tensor"] += int(over_model(self))
        return orig[1](self, *a, **k)

    def redistribute(self, device_mesh=None, placements=None, *a, **k):
        if over_model(self) and placements is not None and \
                not placements[model_dim].is_shard():
            counts["redistribute"] += 1
        return orig[2](self, device_mesh, placements, *a, **k)

    SH.gather, DTensor.full_tensor, DTensor.redistribute = (
        gather, full_tensor, redistribute)
    try:
        tok = torch.from_numpy(tokens)
        _, caches = M.prefill(params, {"tokens": tok[:, :s0 + 1]}, cfg, mesh,
                              max_len=max_len)
        for pos in (s0, s0 + 1):
            _, caches = M.decode_step(params, caches, tok[:, pos:pos + 1],
                                      pos, cfg, mesh)
    finally:
        SH.gather, DTensor.full_tensor, DTensor.redistribute = orig
    placed = sum(over_model(t) for t in leaves(params))
    return counts, placed


def tp_rows_serve_case(arch, shape, cfg_kw, tokens, s0, max_len):
    """:func:`tp_serve_case` with whole parameters, and the prefill
    attention's path counters (``blocks.ATTN_ROWS``: query rows and
    calls by path; decode adds none)."""
    from repro_torch.lm import blocks

    before = dict(blocks.ATTN_ROWS)
    out, bad = tp_serve_case(arch, shape, cfg_kw, tokens, s0, max_len, False)
    return out, bad, {k: blocks.ATTN_ROWS[k] - before[k] for k in before}


def _cfg(arch):
    from repro_torch.configs import get_config

    return get_config(arch, smoke=True)


def tp_rows_share_case(cfg_kw, tokens, s0):
    """A Gemma-2B SMOKE prefill (its 2 query heads split head_dim over
    (1, 4)) sharded and unsharded, each rank: (the scores' flops of every
    ``_gqa_scores`` call by ``launch/op_analysis`` at local shapes,
    sharded and unsharded; the q shapes the scores took; the calls of
    ``gather_from`` along a last dim; the sharded prefill's collectives'
    link bytes by kind)."""
    from repro_torch.launch import op_analysis
    from repro_torch.lm import blocks
    from repro_torch.lm import model as M
    from repro_torch.parallel import collectives as C

    cfg = dataclasses.replace(_cfg("gemma_2b"), **cfg_kw)
    mesh = _mesh((1, 4))
    params = _serve_params(cfg, mesh, False)
    tok = torch.from_numpy(tokens)
    flops, shapes, gathers = [0.0], [], [0]
    orig_scores, orig_gather = blocks._gqa_scores, C.gather_from

    def scores(q, k):
        shapes.append(tuple(q.shape))
        out, cost = op_analysis.analyze(orig_scores, q, k)
        flops[0] += cost.flops
        return out

    def gather_from(x, dim, *a):
        gathers[0] += int(dim in (-1, x.ndim - 1) and x.ndim == 4)
        return orig_gather(x, dim, *a)

    def run(mesh_):
        blocks._gqa_scores, C.gather_from = scores, gather_from
        try:
            return M.prefill(params, {"tokens": tok[:, :s0 + 1]}, cfg, mesh_,
                             max_len=s0)
        finally:
            blocks._gqa_scores, C.gather_from = orig_scores, orig_gather

    run(None)
    whole = flops[0]
    flops[0] = gathers[0] = 0
    shapes.clear()
    run(mesh)
    # the collectives of a second sharded prefill (analyses do not nest)
    _, cost = op_analysis.analyze(M.prefill, params,
                                  {"tokens": tok[:, :s0 + 1]}, cfg, mesh,
                                  max_len=s0)
    return flops[0], whole, shapes, gathers[0], cost.per_collective


def tp_attn_grad_case(arch, shape, tokens):
    """The loss's gradients of every attention layer's ``wq``/``wk``/
    ``wv`` over the mesh, each rank's head_dim pieces gathered whole
    (float SMOKE, ``seq_shard``: each rank attends for its rows)."""
    from repro_torch.lm import model as M
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import tp as tp_lib
    from repro_torch.train.tree import leaves, leaves_with_paths

    cfg = dataclasses.replace(_cfg(arch), seq_shard=True)
    mesh = _mesh(shape)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    local, tp = tp_lib.shard_params(params, cfg, mesh, keep_data=True)
    ps = M.tree_map(lambda t: t.detach().requires_grad_(True), local)
    loss, _ = M.loss_fn(ps, {"tokens": torch.from_numpy(tokens)}, cfg, mesh,
                        tp=tp)
    grads = torch.autograd.grad(loss, leaves(ps), allow_unused=True,
                                materialize_grads=True)
    out = {}
    for (path, _), g in zip(leaves_with_paths(ps), grads):
        names = tuple(str(p) for p in path if not isinstance(p, int))
        if names[-1] in ("wq", "wk", "wv") and "mix" in names:
            out["/".join(str(p) for p in path)] = _np(
                C.gather_from(g, -1, mesh, ("model",)))
    return float(loss.detach()), out


class WorkNotes:
    """A sink of ``kernels/work`` notes: the radix kernels' operations by
    kernel."""

    def __init__(self):
        self.muted, self.ops = 0, {}

    def note(self, w):
        self.ops[w.kernel] = self.ops.get(w.kernel, 0.0) + w.ops

    def made(self, out):
        pass


def radix_serve_notes(cfg, params, tokens, s0, max_len, mesh):
    """The radix kernels' noted operations of a prefill and of one decode
    step (``kernels/work`` notes taken where each wrapper launches)."""
    from repro_torch.kernels import work
    from repro_torch.lm import model as M

    tok = torch.from_numpy(tokens)
    notes = [WorkNotes(), WorkNotes()]
    work._SINKS.append(notes[0])
    try:
        _, caches = M.prefill(params, {"tokens": tok[:, :s0 + 1]}, cfg, mesh,
                              max_len=max_len)
    finally:
        work._SINKS.remove(notes[0])
    work._SINKS.append(notes[1])
    try:
        M.decode_step(params, caches, tok[:, s0:s0 + 1], s0, cfg, mesh)
    finally:
        work._SINKS.remove(notes[1])
    return notes[0].ops, notes[1].ops


def tp_analysis_case(cfg_kw, tokens, s0, max_len):
    """A radix Gemma-2B SMOKE prefill over (1, 4) under
    ``launch/op_analysis``: (its collectives' link bytes by kind, the
    collectives' input bytes as the ranks pass them, and the radix
    kernels' noted operations of a prefill and a decode step)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis
    from repro_torch.lm import model as M

    cfg = dataclasses.replace(get_config("gemma_2b", smoke=True), **cfg_kw)
    mesh = _mesh((1, 4))
    params = _serve_params(cfg, mesh, False)
    tok = torch.from_numpy(tokens)
    _, cost = op_analysis.analyze(lambda: M.prefill(
        params, {"tokens": tok[:, :s0 + 1]}, cfg, mesh, max_len=max_len))
    return (cost.per_collective,
            radix_serve_notes(cfg, params, tokens, s0, max_len, mesh))


# ---------------------------------------------------------------------------
# ZeRO-3 over the data axes and the vocab-parallel loss.
# ---------------------------------------------------------------------------


def fsdp_cfg(arch, cfg_kw):
    """SMOKE ``arch`` with ``seq_shard``, MoE capacity 8.0, and
    ``cfg_kw`` (``moe_impl`` names the MoE dispatch)."""
    from repro_torch.configs import get_config

    kw = dict(cfg_kw)
    cfg = dataclasses.replace(get_config(arch, smoke=True), seq_shard=True)
    impl = kw.pop("moe_impl", None)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, impl=impl or cfg.moe.impl))
    return dataclasses.replace(cfg, **kw)


def fsdp_opt(name, lr):
    from repro_torch.train import optim

    return optim.adam(lr) if name == "adam" else optim.adafactor(lr)


def fsdp_case(arch, shape, axes, tokens, steps, lr, opt_name, cfg_kw):
    """``steps`` sharded steps of ``opt_name`` ("adafactor" / "adam"),
    the state placed by the rule table: ((loss, grad_norm) of each step,
    leaves whose local piece is not their spec's slice)."""
    from repro_torch.lm import model as M

    cfg = fsdp_cfg(arch, cfg_kw)
    mesh = _mesh(shape, axes)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    opt = fsdp_opt(opt_name, lr)
    state, specs = _place_state(cfg, opt, params, mesh)
    step = M.make_train_step(cfg, opt, mesh=mesh)
    losses = []
    for _ in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    return losses, _local_shapes_ok(state, specs, mesh)


def _layer_gather_shapes(params, cfg, mesh) -> set:
    """The shapes a step may gather over the data axes: each float
    leaf's piece, one layer of a stacked leaf, whole over them."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import tp as tp_lib
    from repro_torch.train.tree import leaves_with_paths

    pieces, tp = tp_lib.shard_params(params, cfg, mesh, keep_data=True)
    got = dict(leaves_with_paths(pieces))
    shapes = set()
    for path, (d, axes) in tp.data.items():
        shape = list(got[path].shape)
        shape[d] *= C.group_size(mesh, axes)
        if path[0] in ("segments", "enc_segments"):
            shape = shape[1:]
        shapes.add(tuple(shape))
    return shapes


def fsdp_structure_case(arch, shape, tokens, opt_name):
    """One sharded step on ``shape`` with the collectives watched:
    {"gathers": shapes every data-axis gather gave, "allowed": the
    one-layer shapes, "layers": the stacked layers' leaf count, "stack":
    the stacked pieces' shapes, "start": gathers of a parameter leaf by
    ``redistribute`` / ``full_tensor``, "grads" / "slots": leaves the
    optimizer got at another shape than their piece, "held": leaves of
    the new state whose piece is not their spec's slice, "logits": the
    head's output shapes in the loss}."""
    from torch.distributed.tensor import DTensor

    from repro_torch.lm import model as M
    from repro_torch.parallel import collectives as C
    from repro_torch.train.tree import leaves, leaves_with_paths

    cfg = fsdp_cfg(arch, {})
    mesh = _mesh(shape)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    opt = fsdp_opt(opt_name, 1e-3)
    state, specs = _place_state(cfg, opt, params, mesh)
    placed = {id(t) for t in leaves(state["params"])}
    allowed = sorted(_layer_gather_shapes(state["params"], cfg, mesh))
    seen = {"gathers": [], "start": 0, "grads": [], "slots": [],
            "logits": []}
    orig = (C.fsdp_gather, DTensor.redistribute, DTensor.full_tensor,
            M._lm_head, opt.update)

    def fsdp_gather(x, dim, mesh_, axes):
        out = orig[0](x, dim, mesh_, axes)
        seen["gathers"].append(tuple(out.shape))
        return out

    def redistribute(self, *a, **k):
        seen["start"] += int(id(self) in placed)
        return orig[1](self, *a, **k)

    def full_tensor(self, *a, **k):
        seen["start"] += int(id(self) in placed)
        return orig[2](self, *a, **k)

    def lm_head(*a, **k):
        out = orig[3](*a, **k)
        seen["logits"].append(tuple(out.shape))
        return out

    local = [tuple(t.to_local().shape) for t in leaves(state["params"])]

    def update(grads, st, params_=None, shards=None):
        seen["grads"] += [(i, tuple(g.shape), want) for i, (g, want)
                          in enumerate(zip(leaves(grads), local))
                          if tuple(g.shape) != want]
        if hasattr(st, "nu"):       # adam: mu and nu are the pieces
            seen["slots"] += [(i, tuple(m.shape), want) for i, (m, want)
                              in enumerate(zip(leaves(st.mu), local))
                              if tuple(m.shape) != want]
        return orig[4](grads, st, params_, shards)

    C.fsdp_gather, M._lm_head = fsdp_gather, lm_head
    DTensor.redistribute, DTensor.full_tensor = redistribute, full_tensor
    opt = opt._replace(update=update)
    try:
        step = M.make_train_step(cfg, opt, mesh=mesh)
        state, _ = step(state, {"tokens": torch.from_numpy(tokens)})
    finally:
        C.fsdp_gather, DTensor.redistribute, DTensor.full_tensor = orig[:3]
        M._lm_head = orig[3]
    seen["allowed"] = allowed
    seen["stack"] = sorted({tuple(t.to_local().shape) for p, t
                            in leaves_with_paths(state["params"])
                            if p[0] == "segments"})
    seen["layers"] = sum(t.shape[0] for p, t in leaves_with_paths(params)
                         if p[0] == "segments" and p[-2:] == ("ln1", "w"))
    seen["held"] = _local_shapes_ok(state, specs, mesh)
    seen["vocab"] = cfg.vocab
    return seen


def vocab_ce_case(shape, logits_np, labels_np):
    """``model._vocab_parallel_ce`` on this rank's rows and vocab columns
    of ``logits`` against the whole-logit cross-entropy and argmax of its
    rows: (ce, acc, the columns' gradient of ce, and the same three of
    the whole path, the gradient cut to the rank's columns)."""
    from repro_torch.lm import model as M
    from repro_torch.parallel import tp as tp_lib

    mesh = _mesh(shape)
    tp = tp_lib.TP(mesh, {})
    d, n = mesh.get_local_rank("data"), shape[0]
    rows = logits_np.shape[0] // n
    lg = torch.from_numpy(logits_np[d * rows:(d + 1) * rows])
    lab = torch.from_numpy(labels_np[d * rows:(d + 1) * rows])
    cols = lg.shape[-1] // tp.n
    mine = lg[..., tp.rank * cols:(tp.rank + 1) * cols].clone()
    mine.requires_grad_(True)
    ce, acc = M._vocab_parallel_ce(mine, lab, tp)
    ce.backward()
    whole = lg.clone().requires_grad_(True)
    w_ce = (torch.logsumexp(whole, -1)
            - torch.gather(whole, -1, lab.long()[..., None])[..., 0]).mean()
    w_ce.backward()
    w_acc = (whole.argmax(-1) == lab).to(torch.float32).mean()
    w_g = whole.grad[..., tp.rank * cols:(tp.rank + 1) * cols]
    return (float(ce), float(acc), _np(mine.grad), float(w_ce),
            float(w_acc), _np(w_g))


def vocab_loss_case(shape, tokens, cfg_kw):
    """``loss_fn`` over the mesh on this rank's pieces (the vocab-parallel
    loss where the head splits the vocab) against the whole-logit loss of
    ``forward_train`` on the same pieces: (the vocab-parallel path taken,
    (ce, acc, gradient of the head's piece) of each)."""
    from repro_torch.lm import model as M
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel import tp as tp_lib

    cfg = fsdp_cfg("gemma_2b", cfg_kw)
    mesh = _mesh(shape)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    placed = SH.place(params, SH.param_specs(params, cfg, mesh), mesh)
    pieces, tp = tp_lib.shard_params(placed, cfg, mesh, keep_data=True)
    batch = M._data_shard({"tokens": torch.from_numpy(tokens)}, cfg, mesh)
    out = []
    for vocab_parallel in (True, False):
        ps = M.tree_map(lambda t: t.detach().requires_grad_(True), pieces)
        if vocab_parallel:
            _, m = M.loss_fn(ps, batch, cfg, mesh, tp=tp)
            ce, acc = m["ce"], m["acc"]
        else:
            lg, labels, _ = M.forward_train(ps, batch, cfg, mesh, tp)
            lf = lg.to(torch.float32)
            ce = (torch.logsumexp(lf, -1) - torch.gather(
                lf, -1, labels.long()[..., None])[..., 0]).mean()
            acc = (lf.argmax(-1) == labels).to(torch.float32).mean()
        ce.backward()
        out.append((float(ce), float(acc), _np(ps["embed"].grad)))
    return M._vocab_split(cfg, tp), out
