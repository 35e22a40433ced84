"""The plain references against the program, on the CPU at the test sizes
(VGG-11's ``SMOKE_KWARGS``, GLM4-9B's ``SMOKE``): the same inputs give
the program's answers, and the controls do not."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from bench.nets import cnn, lm
from bench.reference import glm_prefill, vgg_snn

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def config(name, smoke=True):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return {**cfg, **cfg["smoke"]} if smoke else cfg


def test_vgg_smoke_is_the_programs():
    from repro_torch.models import vgg

    cfg = config("vgg11-radix4")
    static, full = cnn.program_net(cfg, cnn.float_params(cfg, 0, CPU))
    want_static, chans = vgg.static("or", vgg.SMOKE_KWARGS["width_mult"])
    assert static == want_static
    assert tuple(cfg["input_hw"]) == vgg.SMOKE_KWARGS["input_hw"]
    assert tuple(cfg["conv_channels"]) + tuple(cfg["fc_widths"]) == chans
    assert cfg["num_classes"] == vgg.SMOKE_KWARGS["num_classes"]
    whole = config("vgg11-radix4", smoke=False)
    assert vgg.static("or")[1] == tuple(whole["conv_channels"]) + tuple(
        whole["fc_widths"]) and whole["num_classes"] == 1000
    shapes = [p["w"].shape for p in full if p is not None]
    assert shapes == [p["w"].shape for p in vgg.init(
        __import__("numpy").random.default_rng(0), **vgg.SMOKE_KWARGS)
        if p is not None]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_vgg_reference_is_the_program(seed):
    from repro_torch import api

    cfg = config("vgg11-radix4")
    params = cnn.float_params(cfg, seed, CPU)
    calib = cnn.calibration(cfg, seed, CPU)
    static, full = cnn.program_net(cfg, params)
    qnet = api.convert(static, full, calib, encoding=api.RadixEncoding(4),
                       weight_bits=cfg["weight_bits"])
    ref = vgg_snn.convert(cfg, params, calib)
    assert ref["input_scale"] == qnet.input_scale
    assert ref["logit_scale"] == qnet.logit_scale
    mine = [q for q in qnet.qlayers if q is not None]
    for a, b in zip(ref["layers"], mine):
        assert torch.equal(a["w_q"], b["w_q"])
        assert torch.equal(a["b_int"], b["b_int"])
        assert (a["mult"] is None) == (b["mult"] is None)
        if a["mult"] is not None:
            assert torch.equal(a["mult"], b["mult"])
    x = cnn.images(cfg, seed, 2, 8, CPU)
    exe = api.Accelerator(device="cpu").compile(qnet, tuple(cfg["input_hw"]),
                                                buckets=(8,))
    got = exe(x)
    want = vgg_snn.forward(cfg, ref, x)
    assert torch.equal(got, want)
    assert float(want.std(dim=0).mean()) > 0, "degenerate logits"
    low = vgg_snn.forward(cfg, ref, x, torch.bfloat16)
    assert not torch.equal(low, want), "the control must differ"


def test_glm_arch_is_the_programs():
    from repro_torch.configs import glm4_9b

    cfg = config("glm4-9b-radix4", smoke=False)
    mine = lm.arch(cfg)
    want = dataclasses.replace(glm4_9b.ARCH, name=mine.name, quant="radix",
                               radix_steps=4, radix_kv_pack=True,
                               packed_attn=True)
    assert mine == want


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5), ("bfloat16", 0.1)])
def test_glm_reference_is_the_program(dtype, bar):
    from repro_torch import api

    cfg = {**config("glm4-9b-radix4"), "dtype": dtype}
    params = lm.params(cfg, 7, CPU)
    exe = api.Accelerator(dataflow="fused", device="cpu").compile(
        (params, lm.arch(cfg)), (2, 33), buckets=(32,))
    tokens = torch.randint(0, cfg["vocab"], (2, 27),
                           generator=torch.Generator().manual_seed(3))
    got = exe.prefill(tokens)["logits"].to(torch.float32)
    ref = glm_prefill.prefill_logits(cfg, params, tokens)
    rel = float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())
    assert rel < bar
    low = glm_prefill.prefill_logits(cfg, params, tokens, "lower")
    low_rel = float(((low - ref).norm(dim=-1) / ref.norm(dim=-1)).max())
    assert low_rel > 3 * rel and low_rel > 0.05
