"""The port's ping-pong memory model (``engine.memory_report`` and
``Executable.memory()``) against the reference's, field by field.

The report is a static model of the paper's accelerator (Sec. III-C): it
reads the net's layer kinds, weight shapes, weight bits and T, and
nothing of the weights' values.  So each net is held here at its full
published width (VGG-11 at 224 x 224 x 3 included, where the paper's
weights no longer fit on chip) with zero-stride placeholder weights in
both packages, under every encoding spec the net's pool mode allows.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import conversion as jconv
from repro.core import encoding as jenc
from repro.core import engine as jengine
from repro_torch import api
from repro_torch.core import conversion as tconv
from repro_torch.core import encoding as tenc
from repro_torch.core import engine as tengine
from repro_torch.models import fang, lenet, vgg

WEIGHT_BITS = 3


def _weight_shapes(static, chans, hw, classes):
    """Each conv/linear layer's HWIO / (fin, fout) weight shape, as the
    models' ``init`` lays them out."""
    h, w, c = hw
    shapes, i, feat = [], 0, None
    for kind, cfg in static:
        if kind == "conv":
            k = cfg.get("kernel", 3)
            shapes.append((k, k, c, chans[i]))
            if cfg.get("padding", "VALID") != "SAME":
                h, w = h - k + 1, w - k + 1
            c, i = chans[i], i + 1
        elif kind == "pool":
            h, w = h // cfg["window"], w // cfg["window"]
        elif kind == "flatten":
            feat = h * w * c
        elif kind == "linear":
            out = chans[i] if i < len(chans) else classes
            shapes.append((feat, out))
            feat, i = out, i + 1
    return shapes


def _net(name):
    """(static, weight shapes, input (H, W, C)) at full width, avg pool."""
    if name == "vgg11":
        static, chans = vgg.static("avg", 1.0)
        hw = (224, 224, 3)
        return static, _weight_shapes(static, chans, hw, vgg.NUM_CLASSES), hw
    model = {"lenet5": lenet, "fang_cnn": fang}[name]
    static, params, hw = model.make(np.random.default_rng(0), pool_mode="avg")
    return static, [tuple(p["w"].shape) for p in params if p is not None], hw


SPECS = [("radix", 4, {}), ("radix", 6, {}), ("rate", 4, {}),
         ("ttfs", 4, {}), ("phase", 8, {"periods": 2})]
_TSPEC = {"radix": tenc.RadixEncoding, "rate": tenc.RateEncoding,
          "ttfs": tenc.TTFSEncoding, "phase": tenc.PhaseEncoding}
_JSPEC = {"radix": jenc.RadixEncoding, "rate": jenc.RateEncoding,
          "ttfs": jenc.TTFSEncoding, "phase": jenc.PhaseEncoding}


def _pair(name, spec):
    """The same net in both packages, weights as zero-stride views."""
    kind, steps, fields = spec
    static, shapes, hw = _net(name)
    it = iter(shapes)
    tl, jl = [], []
    for k, _ in static:
        if k in ("conv", "linear"):
            shape = next(it)
            tl.append({"w_q": torch.zeros((), dtype=torch.int8).expand(shape),
                       "b_int": None, "mult": None})
            jl.append({"w_q": np.broadcast_to(np.int8(0), shape),
                       "b_int": None, "mult": None})
        else:
            tl.append(None)
            jl.append(None)
    tnet = tconv.QuantizedNet(static=static, num_steps=steps,
                              weight_bits=WEIGHT_BITS, qlayers=tl,
                              encoding=_TSPEC[kind](steps, **fields))
    jnet = jconv.QuantizedNet(static=static, num_steps=steps,
                              weight_bits=WEIGHT_BITS, qlayers=jl,
                              encoding=_JSPEC[kind](steps, **fields))
    return tnet, jnet, hw


def _assert_same(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_buffer_bytes == want.total_buffer_bytes
    assert [type(v) for v in dataclasses.asdict(got).values()] == \
        [type(v) for v in dataclasses.asdict(want).values()]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s[0]}{s[1]}")
@pytest.mark.parametrize("name", ["lenet5", "fang_cnn", "vgg11"])
def test_memory_report_equals_reference(name, spec):
    tnet, jnet, hw = _pair(name, spec)
    for kw in ({}, {"bram_capacity_bytes": 1 << 16}):
        _assert_same(tengine.memory_report(tnet, hw, **kw),
                     jengine.memory_report(jnet, hw, **kw))


@pytest.mark.parametrize("name", ["lenet5", "fang_cnn", "vgg11"])
def test_executable_memory_equals_reference(name):
    """``Executable.memory()`` on both packages' compiled executables (no
    plan is built: the report needs none)."""
    for spec in SPECS:
        tnet, jnet, hw = _pair(name, spec)
        backend = "jnp" if spec[0] == "rate" else "kernels"
        exe = api.Accelerator(backend=backend, device="cpu").compile(tnet, hw)
        jexe = japi.Accelerator(backend=backend).compile(jnet, hw)
        _assert_same(exe.memory(), jexe.memory())
        _assert_same(exe.memory(bram_capacity_bytes=1 << 30),
                     jexe.memory(bram_capacity_bytes=1 << 30))
        assert exe.stats()["compiles"] == 0


def test_vgg11_streams_weights_from_dram():
    """The paper's point about VGG-11: its 3-bit weights overflow the
    8 MB of on-chip memory, LeNet-5's and Fang CNN-2's do not."""
    reports = {name: tengine.memory_report(*_pair(name, SPECS[0])[::2])
               for name in ("lenet5", "fang_cnn", "vgg11")}
    assert reports["vgg11"].needs_dram
    assert reports["vgg11"].weight_bram_bytes == 0
    assert not reports["lenet5"].needs_dram
    assert not reports["fang_cnn"].needs_dram


def test_memory_refuses_non_image_nets():
    static = (("linear", {}), ("linear", {}))
    tl = [{"w_q": torch.zeros((16, 8), dtype=torch.int8), "b_int": None,
           "mult": None},
          {"w_q": torch.zeros((8, 4), dtype=torch.int8), "b_int": None,
           "mult": None}]
    tnet = tconv.QuantizedNet(static=static, num_steps=4, weight_bits=3,
                              qlayers=tl)
    exe = api.Accelerator(device="cpu").compile(tnet, (16,))
    with pytest.raises(ValueError, match=r"\(H, W, C\)"):
        exe.memory()
