"""The port's LM serving (``repro_torch.launch.serve_lm``) and the LM leg's
``backend="jnp"`` against the JAX package's.

Both packages serve the reference's Gemma-2B SMOKE weights
(``init_params(PRNGKey(0))``, carried across as numpy) at T = 4 with
``radix_kv_pack`` and ``packed_attn`` on, batch 2, ``max_len`` 24 and
sequence buckets (8, 16), each behind its own ``LMServer(executable=)``
and ``make_queue`` with a fake clock: the reference's kernels backend
(Pallas in interpret mode) against the port's plain path in both
dataflows, and the reference's ``jnp`` backend against the port's.  One
``run_prompt_stream`` on each side: every ticket's tokens equal, the
plan-build and resilience counters equal, and the plan counters the
port's own (its ``infer`` runs a flush larger than the compiled batch in
chunks of it, where the reference's queue bisects the flush); prefill logits within 1e-3
relative L2 with equal argmax, as ``tests/test_torch_lm_serve.py`` holds
them.  Then the mirrors of ``tests/test_lm_radix.py``'s backend lock (the
port's kernels and ``jnp`` backends give equal logits; across T, T = 8
taking the reference's int32 path), its resilience-queue test, a poison
row (a token id equal to the vocab size) quarantined alone, the queue's
defaults, and the CLI's argument errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_config as jget
from repro.launch import serve_lm as jserve
from repro.lm import model as jmodel
from repro_torch import api as tapi
from repro_torch import carry
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve_lm as tserve

COUNTERS = ("compiles", "hits", "executions", "padded_rows", "failures",
            "rejected", "shed", "retried", "quarantined", "degraded_flushes")
KW = dict(radix_steps=4, radix_kv_pack=True, packed_attn=True)
SPEC, BUCKETS = (2, 24), (8, 16)
SIZES = (1, 2, 1, 1, 2, 2, 1)


@pytest.fixture(scope="module")
def weights():
    params = jmodel.init_params(jax.random.PRNGKey(0),
                                jget("gemma_2b", smoke=True))
    return params, jax.tree.map(np.asarray, params)


def _exes(weights, backend, dataflow, **fields):
    """(reference, port) executables on one weight tree: the reference
    runs ``backend``; the port runs ``backend`` on the CPU."""
    jparams, nparams = weights
    kw = dict(KW, **fields)
    jcfg = dataclasses.replace(jget("gemma_2b", smoke=True), **kw)
    tcfg = dataclasses.replace(tget("gemma_2b", smoke=True), **kw)
    exe_j = japi.Accelerator(backend=backend, dataflow=dataflow).compile(
        (jparams, jcfg), SPEC, buckets=BUCKETS)
    exe_t = tapi.Accelerator(backend=backend, dataflow=dataflow,
                             device="cpu").compile(
        (carry.lm_params_from_numpy(nparams, tcfg), tcfg), SPEC,
        buckets=BUCKETS)
    return exe_j, exe_t


def _queue(serve, exe, **kw):
    server = serve.LMServer(executable=exe, prompt_len=kw.pop("prompt_len",
                                                              6),
                            max_new=kw.pop("max_new", 3))
    server.warmup()
    return serve.make_queue(server, timeout_s=1.0, clock=lambda: 0.0,
                            sleep=lambda _s: None, **kw)


def _tokens(ticket):
    return None if ticket.result is None else np.asarray(ticket.result)


def _counters(queue):
    stats = queue.server.stats()
    return {k: stats[k] for k in COUNTERS}


def _chunks(sizes, batch):
    """The rows of each ``generate`` the port's healthy queue makes for
    ``sizes`` under a clock that never times out: a flush once ``batch``
    prompts wait (and one at the end), each run in chunks of ``batch``."""
    out, n = [], 0
    for i, size in enumerate(sizes):
        n += size
        if n >= batch or i == len(sizes) - 1:
            out += [min(batch, n - j) for j in range(0, n, batch)]
            n = 0
    return out


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("backend,dataflow", [("kernels", "fused"),
                                              ("kernels", "bitserial"),
                                              ("jnp", None)])
def test_prompt_stream_matches_reference(weights, backend, dataflow):
    exe_j, exe_t = _exes(weights, backend, dataflow)
    qj, qt = _queue(jserve, exe_j), _queue(tserve, exe_t)
    tj = jserve.run_prompt_stream(qj, SIZES, seed=3)
    tt = tserve.run_prompt_stream(qt, SIZES, seed=3)
    assert [t.size for t in tt] == list(SIZES)
    assert all(t.ok for t in tj) and all(t.ok for t in tt)
    for a, b in zip(tj, tt):
        assert b.result.shape == (b.size, 3)
        np.testing.assert_array_equal(_tokens(b), _tokens(a))
        assert b.latency_s == a.latency_s == 0.0
    ct, cj = _counters(qt), _counters(qj)
    assert ct["compiles"] == len(BUCKETS) + 1
    for k in ("compiles", "failures", "rejected", "shed", "retried",
              "quarantined"):
        assert ct[k] == cj[k], k
    # Where they differ: a flush of more prompts than the compiled batch
    # (2) runs in chunks of it in the port's ``LMServer.infer``; the
    # reference's raises there, and its queue bisects the flush and
    # degrades its health.  The port's plan counters are its chunks'.
    chunks = _chunks(SIZES, SPEC[0])
    assert (qt.flushes, qt.health.state) == (5, "healthy")
    assert ct["degraded_flushes"] == 0 < cj["degraded_flushes"]
    assert ct["executions"] == ct["hits"] == 3 * len(chunks)
    assert ct["padded_rows"] == sum(
        3 * (SPEC[0] - n) + (BUCKETS[0] - 6) for n in chunks)
    # the first request's prompt, prefilled on both sides
    prompts = np.random.default_rng(3).integers(
        0, exe_t.cfg.vocab, (SIZES[0], 6))
    lj = np.asarray(exe_j.prefill(jnp.asarray(prompts, jnp.int32))["logits"])
    lt = exe_t.prefill(prompts)["logits"].numpy()
    assert _rel_l2(lt, lj) <= 1e-3
    np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))
    assert (exe_t.backend, exe_t.dataflow) == (exe_j.backend, exe_j.dataflow)


def test_e2e_kernels_bit_equal_jnp_backend(weights):
    """The port's backend choice is a dataflow choice, not a semantics
    choice: kernels and jnp give equal logits, as in the reference."""
    _, nparams = weights
    cfg = dataclasses.replace(tget("gemma_2b", smoke=True), **KW)
    params = carry.lm_params_from_numpy(nparams, cfg)
    exe_k = tapi.Accelerator(device="cpu").compile((params, cfg), SPEC,
                                                   buckets=BUCKETS)
    exe_n = tapi.Accelerator(backend="jnp", device="cpu").compile(
        (params, cfg), SPEC, buckets=BUCKETS)
    assert exe_n.dataflow is None and not exe_n.cfg.use_kernel
    assert "backend='jnp'" in repr(exe_n)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 7))
    a, b = exe_k.prefill(tok), exe_n.prefill(tok)
    assert torch.equal(a["logits"], b["logits"])
    a = exe_k.decode(a, a["logits"].argmax(-1)[:, None])
    b = exe_n.decode(b, b["logits"].argmax(-1)[:, None])
    assert torch.equal(a["logits"], b["logits"])
    with pytest.raises(ValueError, match="backend='kernels'"):
        tapi.Accelerator(backend="jnp", device="cpu").compile(
            (params, cfg), SPEC, buckets=BUCKETS, autotune=True)


@pytest.mark.parametrize("T", [3, 5, 6, 8])
def test_e2e_kernel_vs_jnp_bit_equal_across_T(weights, T):
    """Across the paper's T range and T = 8, whose 255-level activations
    take the reference's int32 product: the port's kernels and jnp
    backends give the same tokens, and its jnp logits are the reference
    jnp backend's to 1e-3 relative L2 with equal argmax."""
    exe_j, exe_n = _exes(weights, "jnp", None, radix_steps=T)
    _, nparams = weights
    cfg = exe_n.cfg
    exe_k = tapi.Accelerator(device="cpu").compile(
        (carry.lm_params_from_numpy(nparams, cfg), cfg), SPEC,
        buckets=BUCKETS)
    tok = np.random.default_rng(5).integers(0, cfg.vocab, (2, 9))
    assert torch.equal(exe_k.generate(tok, 4), exe_n.generate(tok, 4))
    lj = np.asarray(exe_j.prefill(jnp.asarray(tok, jnp.int32))["logits"])
    ln = exe_n.prefill(tok)["logits"].numpy()
    assert _rel_l2(ln, lj) <= 1e-3
    np.testing.assert_array_equal(ln.argmax(-1), lj.argmax(-1))


def test_lm_server_behind_resilience_queue():
    """The resilience queue drives a seeded LMServer unchanged: tickets
    resolve with (n, max_new) tokens, counters surface through stats(),
    nothing is built after warmup."""
    server = tserve.LMServer(
        "gemma_2b", smoke=True, batch=2, max_len=24, prompt_len=6,
        max_new=3, buckets=BUCKETS, backend="kernels", dataflow="bitserial",
        device="cpu")
    server.warmup()
    compiles0 = server.stats()["compiles"]
    assert compiles0 == len(server.exe.buckets) + 1
    queue = tserve.make_queue(server, timeout_s=0.0)
    assert queue.max_batch == server.exe.batch     # batch, not seq bucket
    tickets = tserve.run_prompt_stream(queue, [1, 2, 1])
    assert all(t.ok for t in tickets)
    for t in tickets:
        assert tuple(t.result.shape) == (t.size, 3)
        assert t.result.dtype == torch.long
        assert bool((t.result >= 0).all() and (t.result < server.vocab).all())
    stats = server.stats()
    assert stats["compiles"] == compiles0          # zero recompiles
    assert stats["rejected"] == stats["quarantined"] == 0
    # a malformed prompt length fails its own submit, poisoning nothing
    with pytest.raises(ValueError, match="item shape"):
        queue.submit(np.zeros((1, 99), np.float32))
    # the seed draws the same weights, hence the same tokens
    again = tserve.LMServer(
        "gemma_2b", smoke=True, batch=2, max_len=24, prompt_len=6,
        max_new=3, buckets=BUCKETS, dataflow="bitserial", device="cpu")
    rows = np.random.default_rng(0).integers(0, server.vocab, (2, 6))
    assert torch.equal(again.infer(rows), server.infer(rows))


def test_poison_row_is_quarantined_alone(weights):
    exe_j, exe_t = _exes(weights, "kernels", "fused")
    qj, qt = _queue(jserve, exe_j), _queue(tserve, exe_t)
    vocab = exe_t.cfg.vocab
    rng = np.random.default_rng(9)
    rows = [rng.integers(0, vocab, (n, 6)).astype(np.float32)
            for n in (1, 2, 1, 1)]
    rows[2][0, 4] = vocab                           # one id out of range
    out = []
    for q in (qj, qt):
        tickets = [q.submit(r) for r in rows]
        q.flush()
        out.append(tickets)
    for tickets in out:
        assert [t.ok for t in tickets] == [True, True, False, True]
        assert "token ids must be in" in str(tickets[2].error.__cause__)
    for a, b in zip(*out):
        if a.ok:
            np.testing.assert_array_equal(_tokens(b), _tokens(a))
    ct, cj = _counters(qt), _counters(qj)
    # the first flush (3 prompts over a batch of 2) runs in chunks in the
    # port; the reference's bisects it, and its degraded health splits
    # the next flushes: every other counter is equal
    assert ct["degraded_flushes"] == 0 < cj["degraded_flushes"]
    assert ({k: v for k, v in ct.items() if k != "degraded_flushes"}
            == {k: v for k, v in cj.items() if k != "degraded_flushes"})
    assert (ct["quarantined"], ct["retried"]) == (1, 2)
    # plans ran for the three healthy requests only: each generate is one
    # prefill and max_new - 1 decode steps, and the first flush (3
    # prompts) ran two of them, the healthy request bisected out one
    assert qt.flushes == 2
    assert ct["executions"] == (2 + 1) * 3
    with pytest.raises(ValueError, match=r"token ids must be in \[0, "):
        qt.server.infer(np.full((1, 6), -1, np.float32))


def test_make_queue_defaults(weights):
    for serve, exe in zip((jserve, tserve),
                          _exes(weights, "kernels", "fused")):
        server = serve.LMServer(executable=exe, prompt_len=6, max_new=3)
        q = serve.make_queue(server)
        assert (q.max_batch, q.degraded_max_batch) == (2, 1)
        q = serve.make_queue(server, max_batch=1, degraded_max_batch=1)
        assert (q.max_batch, q.degraded_max_batch) == (1, 1)


SERVER_ERRORS = [
    (dict(prompt_len=0), "prompt_len >= 1"),
    (dict(max_new=0), "max_new >= 1"),
    (dict(prompt_len=17), "exceeds the top sequence bucket"),
    (dict(prompt_len=16, max_new=10), "exceed the compiled cache"),
]


@pytest.mark.parametrize("kw,match", SERVER_ERRORS,
                         ids=[m for _, m in SERVER_ERRORS])
def test_server_rejects_like_reference(weights, kw, match):
    for serve, exe in zip((jserve, tserve),
                          _exes(weights, "kernels", "fused")):
        with pytest.raises(ValueError, match=match):
            serve.LMServer(executable=exe, **{"prompt_len": 6, "max_new": 3,
                                              **kw})


BAD_ARGV = {
    "batch": ["--batch", "0"],
    "max-len": ["--max-len", "1"],
    "prompt-len": ["--prompt-len", "0"],
    "max-new": ["--max-new", "0"],
    "requests": ["--requests", "0"],
    "retries": ["--retries", "-1"],
    "timeout": ["--timeout-ms", "-1"],
    "deadline": ["--deadline-ms", "0"],
    "buckets": ["--buckets", "8,x"],
    "arch": ["--arch", "gpt5"],
    "backend": ["--backend", "xla"],
    "dataflow": ["--dataflow", "rowwise"],
}


@pytest.mark.parametrize("case", sorted(BAD_ARGV))
def test_cli_errors_like_reference(case, capsys):
    errs = []
    for serve in (jserve, tserve):
        with pytest.raises(SystemExit) as exc:
            serve._parse_args(BAD_ARGV[case])
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[1].split("error:")[-1] == errs[0].split("error:")[-1]


def test_cli_parses_like_reference():
    argv = ["--smoke", "--batch", "3", "--buckets", "8,16", "--num-steps",
            "5", "--radix-attn", "--autotune", "--deadline-ms", "40"]
    j, t = jserve._parse_args(argv), tserve._parse_args(argv)
    assert {k: v for k, v in vars(t).items() if k != "device"} == vars(j)
    assert t.device is None


@pytest.mark.parametrize("backend", ["kernels", "jnp"])
def test_cli_serves_every_request_on_cpu(backend, capsys):
    # a flush that collects more prompts than the compiled batch runs in
    # chunks of it: every request is served and the health stays healthy
    out = tserve.main(["--smoke", "--device", "cpu", "--requests", "5",
                       "--backend", backend, "--max-new", "3"])
    assert out["ok"] == out["requests"] == 5
    assert out["steady_compiles"] == 0
    assert out["tokens"] == out["prompts"] * 3
    assert out["stats"]["failures"] == out["stats"]["quarantined"] == 0
    assert out["stats"]["degraded_flushes"] == 0
    assert out["health"] == "healthy"
    assert f"backend='{backend}'" in capsys.readouterr().out
