"""The readers of the program's spans (``bench/spans.py`` and the five
metrics built on it), through traced runs of both cells on the CPU at
the test sizes: the host readers read, the device readers are silent
(spans have no device time on the CPU), the padding share is the one the
driver's lengths give, and a reader is silent when a span is missing or
the program keeps none."""

import sys

import pytest

from bench import harness
from bench import spans as bench_spans

SEED = 2 ** 31 + 211
HOST = {"vgg11-radix4.offline-b64": ["plan_host_ms.images",
                                     "prepass_host_ms.images"],
        "glm4-9b-radix4.long-prompt": ["prefill_pad_share.lm"]}
DEVICE = ["attention_device_ms.lm", "ffn_device_ms.lm"]


@pytest.fixture(scope="module")
def traced():
    """Each cell's traced result and the view its metrics read."""
    out = {}
    view = harness.Tracer.view
    for cell in HOST:
        seen = []

        def keep(self, *args, seen=seen):
            v = view(self, *args)
            seen.append(v)
            return v

        harness.Tracer.view = keep
        try:
            r = harness.run_cell(cell, SEED, 0.5, True, device="cpu",
                                 smoke=True)
        finally:
            harness.Tracer.view = view
        out[cell] = (r, seen[0])
    return out


def read(name, view):
    return harness.load_module("metrics", name, [harness.BENCH]).read(view)


@pytest.mark.parametrize("cell", sorted(HOST))
def test_host_readers_read_and_device_readers_are_silent(traced, cell):
    r, _ = traced[cell]
    assert r["correct"], r["checks"]
    for name in HOST[cell]:
        assert r["metrics"][name]["value"] > 0, name
    assert not set(DEVICE) & set(r["metrics"])


def test_prepass_is_a_part_of_the_plan(traced):
    r, _ = traced["vgg11-radix4.offline-b64"]
    m = r["metrics"]
    assert m["prepass_host_ms.images"]["value"] < \
        m["plan_host_ms.images"]["value"]


def test_pad_share_is_the_drivers_lengths(traced):
    r, view = traced["glm4-9b-radix4.long-prompt"]
    lengths, batch = view.info["lengths"], view.info["batch"]
    true = sum(batch * n for n in lengths)
    computed = len(lengths) * batch * view.info["bucket"]
    assert r["metrics"]["prefill_pad_share.lm"]["value"] == pytest.approx(
        100.0 * (1.0 - true / computed), rel=1e-12)


@pytest.mark.parametrize("name,span", [
    ("plan_host_ms.images", "plan.forward"),
    ("prepass_host_ms.images", "plan.occupancy"),
    ("prefill_pad_share.lm", "lm.prefill"),
    ("attention_device_ms.lm", "lm.attention"),
    ("ffn_device_ms.lm", "lm.ffn"),
])
def test_a_reader_is_silent_when_a_span_is_missing(traced, monkeypatch,
                                                   name, span):
    from repro_torch import trace

    cell = ("glm4-9b-radix4.long-prompt" if name.endswith(".lm")
            else "vgg11-radix4.offline-b64")
    _, view = traced[cell]
    if name in HOST[cell]:
        assert read(name, view) is not None
    gone = bench_spans.inside(view, span)[0]
    spans = trace.spans
    monkeypatch.setattr(trace, "spans", lambda n=None: [
        s for s in spans(n) if s is not gone])
    assert read(name, view) is None


@pytest.mark.parametrize("name", sorted(sum(HOST.values(), DEVICE)))
def test_a_program_without_spans_leaves_the_metric_out(traced, monkeypatch,
                                                       name):
    """The parent of the program that added the spans has no
    ``repro_torch.trace``: the readers are silent there and do not
    raise."""
    cell = ("glm4-9b-radix4.long-prompt" if name.endswith(".lm")
            else "vgg11-radix4.offline-b64")
    import repro_torch

    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert read(name, traced[cell][1]) is None
