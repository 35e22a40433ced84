"""The harness driven end to end on the CPU at the test sizes: a cell,
configuration or metric that exists only as new files runs; and with the
timed path broken underneath, ``correct`` comes out false."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import harness

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 101


def manifest_for(cell, e2e, layer=()):
    return {"end_to_end": [{"name": n, "unit": u, "workloads": [cell]}
                           for n, u in e2e]
            + [{"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": n, "unit": u, "moves": e2e[0][0],
                           "workloads": [cell]} for n, u in layer]}


def run(cell, manifest=None, trace=False, seconds=0.5, roots=(BENCH,)):
    return harness.run_cell(cell, SEED, seconds, trace, roots=roots,
                            manifest=manifest, device="cpu", smoke=True)


def test_new_cell_and_metric_are_files_only(tmp_path):
    """A cell, a configuration and a per-layer metric added as files under
    another root, with no edit to any file here, are found and run."""
    (tmp_path / "workloads").mkdir()
    (tmp_path / "configs").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = json.loads((BENCH / "configs" / "vgg11-radix4.json").read_text())
    cfg["name"] = "vgg11-radix4-wide"
    cfg["smoke"]["conv_channels"] = [8] * 8
    (tmp_path / "configs" / "vgg11-radix4-wide.json").write_text(
        json.dumps(cfg))
    cell = "vgg11-radix4-wide.offline-b2"
    (tmp_path / "workloads" / f"{cell}.json").write_text(json.dumps({
        "config": "vgg11-radix4-wide", "traffic": "offline-b2",
        "driver": "cnn_offline", "batch": 2, "buckets": [2],
        "pool_images": 8, "why": "a cell of files only"}))
    (tmp_path / "metrics" / "calls_per_s.b2.py").write_text(
        "def read(t):\n    return t.info['calls'] / t.window_s\n")
    m = manifest_for(cell, [("images_per_s", "images/s")],
                     [("calls_per_s.b2", "calls/s"),
                      ("device_idle.images", "%")])
    r = run(cell, m, roots=(tmp_path, BENCH))
    assert r["correct"] and r["attempted"] > 0
    assert set(r["metrics"]) == {"images_per_s", "setup_s"}
    assert r["metrics"]["images_per_s"]["value"] > 0
    assert list(r)[-1] == "checks"
    r = run(cell, m, trace=True, roots=(tmp_path, BENCH))
    assert r["correct"]
    assert r["metrics"]["calls_per_s.b2"]["value"] > 0
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("cell,e2e", [
    ("vgg11-radix4.offline-b64", "images_per_s"),
    ("glm4-9b-radix4.long-prompt", "lm_tokens_per_s"),
])
def test_sound_runs_are_correct(cell, e2e):
    m = manifest_for(cell, [(e2e, "x")])
    r = run(cell, m, seconds=1.0)
    assert r["correct"], r["checks"]
    assert r["metrics"][e2e]["value"] > 0 and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())


def _broken_executable(monkeypatch, how):
    from repro_torch import api

    inner = api.Executable.__call__

    def call(self, x):
        y = inner(self, x).clone()
        if how == "answer":
            y[0, 0] += 1.0
        else:                                   # half the batch left out
            half = max(1, len(y) // 2)
            y[half:] = y[:half].mean(dim=0)
        return y

    monkeypatch.setattr(api.Executable, "__call__", call)


@pytest.mark.parametrize("how", ["answer", "half_batch"])
def test_broken_cnn_path_is_not_correct(monkeypatch, how):
    _broken_executable(monkeypatch, how)
    cell = "vgg11-radix4.offline-b64"
    r = run(cell, manifest_for(cell, [("images_per_s", "images/s")]),
            seconds=1.0)
    assert not r["correct"]
    assert r["checks"]["logits_differing"]["value"] > 0


def _broken_lm(monkeypatch, how):
    from repro_torch import api
    from repro_torch.lm import model

    if how == "layer_unchanged":
        inner_layer = model._apply_layer
        seen = []

        def layer(h, *args, **kwargs):
            seen.append(1)
            out = inner_layer(h, *args, **kwargs)
            return (h,) + tuple(out[1:]) if len(seen) % 3 == 2 else out

        monkeypatch.setattr(model, "_apply_layer", layer)
        return
    inner = api.LMExecutable.prefill

    def prefill(self, prompts):
        state = inner(self, prompts)
        logits = state["logits"].clone()
        if how == "answer":
            logits[0] = torch.roll(logits[0], 1)
        else:
            half = max(1, len(logits) // 2)
            logits[half:] = logits[:half].mean(dim=0)
        return {**state, "logits": logits}

    monkeypatch.setattr(api.LMExecutable, "prefill", prefill)


@pytest.mark.parametrize("how", ["answer", "half_batch", "layer_unchanged"])
def test_broken_lm_path_is_not_correct(monkeypatch, how):
    _broken_lm(monkeypatch, how)
    cell = "glm4-9b-radix4.long-prompt"
    r = run(cell, manifest_for(cell, [("lm_tokens_per_s", "tokens/s")]))
    assert not r["correct"], r["checks"]


def test_cli_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "vgg11-radix4.offline-b64", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(BENCH)})
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0
    assert out.stdout.strip() == "" and "CUDA" in out.stderr


def test_forbidden_modules_are_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro", object())
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert harness.loaded_forbidden() == ["repro"]


def test_a_run_with_jax_loaded_gives_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    cell = "vgg11-radix4.offline-b64"
    with pytest.raises(harness.ForbiddenImport, match="jax"):
        run(cell, manifest_for(cell, [("images_per_s", "images/s")]))
