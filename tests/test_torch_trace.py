"""The port's spans (``repro_torch.trace``) and the per-layer state hook
of ``LMExecutable.prefill``, on the CPU.

A small radix CNN (two SAME convs, an 'or' pool, two linears) and the
GLM4-9B SMOKE config are compiled once for the module.  Nothing is
recorded while tracing is off; under ``torch.profiler.profile`` a CNN
call records one ``plan.forward`` with one ``plan.occupancy`` child per
kernel layer, and a prefill its ``tokens`` / ``true_tokens`` and one
``lm.attention`` and ``lm.ffn`` span a layer, with no device time on the
CPU; the outputs are the same with tracing on and off; a span's ends
lie inside the profiler's interval of a ``record_function`` around the
call (the shared clock); the state hook hands out what the benchmark's
rebinding of the program's private functions captures.
"""

import collections
import os
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro_torch import api, trace
from repro_torch.configs import get_config
from repro_torch.lm import model

ROOT = Path(__file__).resolve().parents[1]
BATCH, BUCKET, MAX_LEN = 2, 16, 24
KERNEL_LAYERS = 4                       # two convs, two linears


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def cnn():
    g = torch.Generator().manual_seed(0)
    same = {"stride": 1, "padding": "SAME"}
    static = (("conv", same), ("pool", {"window": 2, "mode": "or"}),
              ("conv", same), ("flatten", {}), ("linear", {}),
              ("linear", {}))
    params = [{"w": 0.5 * torch.randn(3, 3, 3, 4, generator=g),
               "b": 0.05 * torch.randn(4, generator=g)}, None,
              {"w": 0.3 * torch.randn(3, 3, 4, 6, generator=g),
               "b": 0.05 * torch.randn(6, generator=g)}, None,
              {"w": 0.1 * torch.randn(96, 10, generator=g),
               "b": torch.zeros(10)},
              {"w": 0.3 * torch.randn(10, 5, generator=g),
               "b": torch.zeros(5)}]
    qnet = api.convert(static, params, torch.rand(4, 8, 8, 3, generator=g),
                       encoding=api.RadixEncoding(4))
    exe = api.Accelerator(device="cpu").compile(qnet, (8, 8, 3),
                                                buckets=(4,)).warmup()
    return exe, torch.rand(3, 8, 8, 3, generator=g)


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("glm4_9b", smoke=True)
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    exe = api.Accelerator(device="cpu").compile(
        (params, cfg), (BATCH, MAX_LEN), buckets=(BUCKET,))
    prompts = torch.randint(0, cfg.vocab, (1, 11),
                            generator=torch.Generator().manual_seed(1))
    return exe, prompts


def test_nothing_is_recorded_while_tracing_is_off(cnn, lm):
    exe, x = cnn
    exe(x)
    lm[0].prefill(lm[1])
    assert trace.spans() == [] and trace.dropped() == 0


def test_cnn_call_under_the_profiler(cnn):
    exe, x = cnn
    with torch.profiler.profile():
        exe(x)
    got = trace.spans()
    fwd = [s for s in got if s.name == "plan.forward"]
    occ = [s for s in got if s.name == "plan.occupancy"]
    assert len(fwd) == 1 and len(occ) == KERNEL_LAYERS
    assert len(got) == 1 + KERNEL_LAYERS
    assert fwd[0].counts == {"images": 4}           # the bucket's rows
    assert fwd[0].parent is None and fwd[0].root == fwd[0].id
    assert all(s.parent == s.root == fwd[0].id for s in occ)
    assert all(fwd[0].start_ns <= s.start_ns <= s.end_ns <= fwd[0].end_ns
               for s in occ)
    assert all(s.device_ms is None for s in got)
    exe(x)                                          # off again
    assert len(trace.spans()) == len(got)


def test_prefill_counts_and_layer_spans(lm):
    exe, prompts = lm
    n, s0 = prompts.shape
    with trace.recording():
        exe.prefill(prompts)
    (pre,) = trace.spans("lm.prefill")
    assert pre.counts == {"tokens": BATCH * BUCKET, "true_tokens": n * s0}
    for name in ("lm.attention", "lm.ffn"):
        got = trace.spans(name)
        assert len(got) == exe.cfg.n_layers
        assert all(s.root == s.parent == pre.id and s.device_ms is None
                   for s in got)
    kinds = [s.name for s in trace.spans() if s.parent is not None]
    assert kinds == ["lm.attention", "lm.ffn"] * exe.cfg.n_layers


def test_outputs_are_the_same_with_tracing_on_and_off(cnn, lm):
    exe, x = cnn
    lm_exe, prompts = lm
    y, logits = exe(x), lm_exe.prefill(prompts)["logits"]
    with trace.recording():
        y_on, logits_on = exe(x), lm_exe.prefill(prompts)["logits"]
    assert trace.spans()
    assert torch.equal(y, y_on) and torch.equal(logits, logits_on)


def test_spans_share_the_profiler_clock(cnn):
    """A program span's start and end lie inside the profiler's interval
    of a ``record_function`` opened around the call, within 20 us."""
    exe, x = cnn
    with torch.profiler.profile() as prof:
        with torch.profiler.record_function("outer"):
            exe(x)
    (outer,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "outer"]
    lo, hi = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    (fwd,) = trace.spans("plan.forward")
    slack = 20_000
    assert lo - slack <= fwd.start_ns <= fwd.end_ns <= hi + slack
    assert fwd.end_ns - fwd.start_ns <= hi - lo + 2 * slack


def test_recording_nests_and_the_buffer_is_bounded(cnn, monkeypatch):
    exe, x = cnn
    monkeypatch.setattr(trace, "_buffer", collections.deque(maxlen=3))
    with trace.recording():
        with trace.recording():
            exe(x)
        exe(x)
    exe(x)
    assert [s.name for s in trace.spans()] == [
        "plan.occupancy", "plan.occupancy", "plan.forward"]
    assert trace.dropped() == 2 * (1 + KERNEL_LAYERS) - 3
    roots = {s.root for s in trace.spans()}
    assert roots == {trace.spans("plan.forward")[0].id}


def test_spans_from_many_threads():
    """Threads (more than cores) nest spans at once: every span is kept,
    and each one's parent and root are its own thread's."""
    threads, per = 2 * len(os.sched_getaffinity(0)) + 1, 100
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for i in range(per):
            with trace.span("outer", thread=k):
                with trace.span("inner", thread=k):
                    pass

    try:
        with trace.recording():
            pool = [threading.Thread(target=work, args=(k,))
                    for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    got = trace.spans()
    assert len(got) == 2 * threads * per and trace.dropped() == 0
    outer = {s.id: s for s in got if s.name == "outer"}
    assert len({s.id for s in got}) == len(got)
    for s in got:
        if s.name == "inner":
            o = outer[s.parent]
            assert s.root == o.id == o.root
            assert o.counts == s.counts
            assert o.start_ns <= s.start_ns <= s.end_ns <= o.end_ns


def test_state_hook_matches_the_benchmarks_rebinding(lm):
    """``prefill(..., on_state=)`` hands out the tensors that the
    benchmark's GLM4-9B check captures by rebinding the program's
    private layer functions (``bench/drivers/lm_prefill.py``), at the
    smoke sizes."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench import harness

    wl, cfg = harness.load_cell("glm4-9b-radix4.long-prompt",
                                [harness.BENCH], smoke=True)
    wl = {**wl, "check_calls": 1}
    run = harness.Run("glm4-9b-radix4.long-prompt", 2 ** 31 + 7, 0.0, cfg,
                      wl, torch.device("cpu"), harness.Tracer(False))
    driver = harness.load_module("drivers", wl["driver"],
                                 [harness.BENCH]).Driver(run)
    driver.window()
    exe = driver.exe
    driver.release()
    (served,) = driver.served
    length = served.prompts.shape[1]
    kept = {"input": [], "attention": [], "ffn": [], "output": []}
    layers = []

    def on_state(layer, kind, h):
        layers.append((layer, kind))
        kept[kind].append(h[:, :length].clone())

    logits = exe.prefill(served.prompts, on_state=on_state)["logits"]
    n = cfg["n_layers"]
    assert torch.equal(logits, served.again)
    assert layers == [(i, k) for i in range(n)
                      for k in ("input", "attention", "ffn")] + [
        (n - 1, "output")]
    states = kept["input"] + kept["output"]
    for mine, theirs in ((states, served.states),
                         (kept["attention"], served.attn),
                         (kept["ffn"], served.ffn)):
        assert len(mine) == len(theirs)
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
