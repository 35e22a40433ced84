"""The LM's fused radix products: the one-pass activation quantize, its
SwiGLU / GeGLU variant, the ``radix_matmul`` dequantize epilogue, and the
routing between the fused path and the int32 path (``lm/radix.py``).

On the CPU the kernels' plain twins (``radix_quantize_plain``,
``radix_matmul_plain(dequant=)``) are held ``torch.equal`` to the unfused
expressions the int32 path ran before them (the activation quantize,
the float32 glue of ``maybe_radix_matmul``, ``F.silu(g) * u``), in
float32 and bfloat16, at T = 4 and 8, on ragged shapes; the fused route
through ``blocks.ffn`` (taken on the CPU by a predicate that ignores the
device) gives the int32 route's bits for every dense FFN of the GLM4-9B
SMOKE config.

The tests marked ``cuda`` need an NVIDIA GPU and skip without one.  On
the card they hold the CUDA kernels ``torch.equal`` to the plain twins
at GLM4-9B's gate / up / down shapes (a reduced, ragged M) and its
unembed (M = 8, N = 151,552), the activations ``torch.equal`` to
PyTorch's over every finite bfloat16 gate value, and a prefill of a
bf16 GLM4-9B SMOKE model to one ``radix_matmul_kernel`` a radix product
with logits equal to the int32 path's::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_radix_fused.py
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import radix_matmul as rmm
from repro_torch.lm import blocks, model
from repro_torch.lm import radix as radix_lib

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SHAPES = [(13, 40, 27), (1, 64, 130), (37, 19, 8)]     # ragged M, K, N


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on CUDA: the routing predicate's
    other conditions, seen alone."""

    @property
    def is_cuda(self):
        return True


def _any_device(real):
    """``radix.fused_path`` with the device condition taken as met, so the
    fused route runs on the CPU through the kernels' plain twins."""
    def fused_path(x, w, cfg, **kw):
        return real(x.as_subclass(_OnCard), w, cfg, **kw)
    return fused_path


def _acts(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * torch.rand(
        shape[:-1] + (1,), generator=g) * 4
    x[0, : shape[-1] // 2] = 0.0         # a half-zero row
    if shape[0] > 2:
        x[2] = 0.0                       # an all-zero row
    return x.to(dtype)


def _unfused_quantize(x, t):
    """The int32 path's activation quantize as the port wrote it before the
    one-pass kernel: levels of ``(x / s + 1) / 2`` against ``s = absmax +
    1e-9``."""
    lvl = (1 << t) - 1
    a = x.abs().amax(dim=-1, keepdim=True).to(torch.float32)
    s = a + 1e-9
    u = (x.to(torch.float32) / s + 1.0) * 0.5
    return torch.clamp(torch.round(u * lvl), 0, lvl).to(torch.uint8), s


def _weight(k, n, seed):
    w = torch.randn(k, n, generator=torch.Generator().manual_seed(seed))
    return radix_lib.quantize_weight(w / k ** 0.5)


# ---------------------------------------------------------------------------
# The plain twins against the unfused expressions.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [4, 8])
@pytest.mark.parametrize("mkn", SHAPES)
def test_dequant_epilogue_twin_is_the_float32_glue(dtype, t, mkn):
    m, k, n = mkn
    x = _acts((m, k), DTYPES[dtype], 1)
    w = _weight(k, n, 2)
    qx, sx = radix_lib._radix_activation(x, t)
    lvl = (1 << t) - 1
    acc = radix_lib._int_product(qx, w["q"])
    colsum = w["q"].sum(dim=-2, dtype=torch.int32)
    want = (2.0 / lvl) * acc.to(torch.float32) - colsum.to(torch.float32)
    want = (want * sx * w["scale"]).to(x.dtype)
    d = rmm.Dequant(sx, w["scale"], colsum, 2.0 / lvl, x.dtype)
    for kmajor, wq in ((False, w["q"]), (True, w["q"].T.contiguous())):
        for method in ("fused", "bitserial"):
            got = rmm.radix_matmul_cuda(qx, wq, num_steps=t, method=method,
                                        kmajor=kmajor, dequant=d)
            assert got.dtype == x.dtype and torch.equal(got, want)
    assert torch.equal(rmm.dequantize(acc, d), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [4, 8])
@pytest.mark.parametrize("shape", [(5, 33), (9, 128), (3, 4, 17)])
def test_one_pass_quantize_twin_is_radix_activation(dtype, t, shape):
    x = _acts(shape, DTYPES[dtype], 3)
    q, s = rmm.radix_quantize_cuda(x, t)            # CPU: the plain twin
    want_q, want_s = _unfused_quantize(x, t)
    assert q.dtype == torch.uint8 and s.dtype == torch.float32
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    for got in (radix_lib._radix_activation(x, t),
                rmm.quantize_rows(x, t, row_max=lambda a: a)):
        assert all(torch.equal(a, b) for a, b in zip(got, (q, s)))
    assert int(q.max()) <= (1 << t) - 1


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [4, 8])
def test_glu_quantize_twin_is_the_torch_product(act, dtype, t):
    g, u = _acts((7, 50), DTYPES[dtype], 4), _acts((7, 50), DTYPES[dtype], 5)
    h_want = (F.silu(g) if act == "swiglu"
              else F.gelu(g, approximate="tanh")) * u
    h = torch.empty_like(g)
    q, s = rmm.radix_quantize_cuda(g, t, act=act, up=u, h=h)
    want_q, want_s = _unfused_quantize(h_want, t)
    assert torch.equal(h, h_want)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)


def test_quantize_rejects_what_the_kernel_does_not_take():
    x = torch.randn(2, 8)
    with pytest.raises(ValueError):
        rmm.radix_quantize_plain(x, 4, act="relu", up=x)
    with pytest.raises(ValueError):
        rmm.radix_matmul_cuda(
            torch.zeros(2, 8, dtype=torch.uint8),
            torch.zeros(8, 3, dtype=torch.int8), num_steps=4,
            mult=torch.ones(3),
            dequant=rmm.Dequant(torch.ones(2), torch.ones(3),
                                torch.zeros(3, dtype=torch.int32), 0.1,
                                torch.float32))
    assert rmm.quantize_fits(13696, torch.bfloat16)
    assert not rmm.quantize_fits(13696, torch.float16)
    assert not rmm.quantize_fits(rmm.QUANT_SMEM // 4 + 1, torch.float32)


def test_work_notes_of_the_fused_product():
    from repro_torch.kernels import work

    plain = work.gemm("radix_matmul", 16, 64, 32, x_bytes=16 * 64,
                      epilogue=False, occupancy=False)
    deq = work.gemm("radix_matmul", 16, 64, 32, x_bytes=16 * 64,
                    epilogue=False, occupancy=False, out_bytes=2)
    assert plain.nbytes - deq.nbytes == 16 * 32 * 2 - 4 * 16 - 8 * 32
    assert deq.ops == plain.ops
    q = work.quantize(16, 64, x_bytes=16 * 64 * 2, glu=True)
    assert q.nbytes == 2 * 16 * 64 * 2 + 16 * 64 + 4 * 16


# ---------------------------------------------------------------------------
# Routing: the predicate, the counter and the fused route on the CPU.
# ---------------------------------------------------------------------------


@pytest.fixture
def smoke():
    cfg = dataclasses.replace(get_config("glm4_9b", smoke=True),
                              quant="radix", use_kernel=True)
    g = torch.Generator().manual_seed(0)
    params = model.kmajor_params(model.radixify_params(
        model.init_params(g, cfg), cfg))
    (layer,), = params["segments"]
    ffn = model.tree_map(lambda t: t[0], layer["ffn"])
    return cfg, ffn, torch.randn(2, 5, cfg.d_model, generator=g)


def test_the_predicate_and_the_counter(smoke):
    cfg, ffn, x = smoke
    w = ffn["w_gate"]
    card = x.as_subclass(_OnCard)
    grad = x.clone().requires_grad_().as_subclass(_OnCard)
    assert radix_lib.fused_path(card, w, cfg)
    assert not radix_lib.fused_path(x, w, cfg)                     # the CPU
    assert not radix_lib.fused_path(card, w, cfg, use_kernel=False)
    assert not radix_lib.fused_path(
        card, w, dataclasses.replace(cfg, use_kernel=False))
    assert not radix_lib.fused_path(card, w, cfg, tp=object())  # row-parallel
    assert not radix_lib.fused_path(grad, w, cfg)
    assert not radix_lib.fused_path(
        card, w, cfg, up=torch.ones(1, requires_grad=True))
    with torch.no_grad():
        assert radix_lib.fused_path(grad, w, cfg)
    assert not radix_lib.fused_path(card.to(torch.float16), w, cfg)
    assert not radix_lib.fused_path(card, w["scale"], cfg)         # exact
    before = dict(radix_lib.PRODUCTS)
    radix_lib.maybe_radix_matmul(x, w, cfg=cfg)
    radix_lib.maybe_radix_matmul(x, w, cfg=cfg, use_kernel=False)
    radix_lib.maybe_radix_matmul(x.clone().requires_grad_(), w, cfg=cfg)
    assert radix_lib.PRODUCTS == {"fused": before["fused"],
                                  "int32": before["int32"] + 3}


def test_levels_take_the_fused_path_only(smoke):
    cfg, ffn, x = smoke
    lv = radix_lib.Levels(*rmm.radix_quantize_plain(x, cfg.radix_steps),
                          x.dtype)
    for kw in ({"tp": object()}, {"use_kernel": False}):
        with pytest.raises(ValueError):
            radix_lib.maybe_radix_matmul(lv, ffn["w_gate"], cfg=cfg, **kw)
    with pytest.raises(ValueError):
        radix_lib.maybe_radix_matmul(lv, ffn["w_gate"]["scale"], cfg=cfg)
    with pytest.raises(ValueError):
        radix_lib.maybe_radix_matmul(
            lv, ffn["w_gate"], cfg=dataclasses.replace(cfg, use_kernel=False))
    want = radix_lib.maybe_radix_matmul(x, ffn["w_gate"], cfg=cfg)
    got = radix_lib.maybe_radix_matmul(lv, ffn["w_gate"], cfg=cfg)
    assert torch.equal(got, want)


def test_the_inputs_follow_the_predicate(smoke):
    cfg, ffn, x = smoke
    card = x.as_subclass(_OnCard)
    g, u = x[..., :7], x[..., 7:14]
    assert radix_lib.radix_input(x, ffn["w_gate"], cfg) is x      # the CPU
    lv = radix_lib.radix_input(card, ffn["w_gate"], cfg)
    assert isinstance(lv, radix_lib.Levels) and lv.dtype == x.dtype
    assert all(torch.equal(a, b) for a, b in zip(
        lv[:2], rmm.radix_quantize_plain(x, cfg.radix_steps)))
    h = F.silu(g) * u
    assert torch.equal(radix_lib.glu_input(g, u, ffn["w_down"], cfg), h)
    lv = radix_lib.glu_input(g.as_subclass(_OnCard), u, ffn["w_down"], cfg)
    assert isinstance(lv, radix_lib.Levels)
    assert all(torch.equal(a, b) for a, b in zip(
        lv[:2], _unfused_quantize(h, cfg.radix_steps)))
    assert torch.equal(radix_lib.glu_input(
        g.as_subclass(_OnCard), u, ffn["w_down"], cfg, tp=object()), h)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu_mlp", "relu_sq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ffn_route_gives_the_int32_routes_bits(act, dtype,
                                                     monkeypatch):
    cfg = dataclasses.replace(get_config("glm4_9b", smoke=True), act=act,
                              dtype=dtype, quant="radix", use_kernel=True)
    g = torch.Generator().manual_seed(1)
    params = model.kmajor_params(model.radixify_params(
        model.init_params(g, cfg), cfg))
    (layer,), = params["segments"]
    ffn = model.tree_map(lambda t: t[0], layer["ffn"])
    x = torch.randn(2, 9, cfg.d_model, generator=g).to(
        radix_lib.torch_dtype(dtype))
    before = dict(radix_lib.PRODUCTS)
    want = blocks.ffn(x, ffn, cfg)
    n = 3 if act in ("swiglu", "geglu") else 2
    assert radix_lib.PRODUCTS["int32"] == before["int32"] + n
    monkeypatch.setattr(radix_lib, "fused_path",
                        _any_device(radix_lib.fused_path))
    launches = rmm.radix_quantize_cuda.launches
    got = blocks.ffn(x, ffn, cfg)
    assert radix_lib.PRODUCTS["fused"] == before["fused"] + n
    assert rmm.radix_quantize_cuda.launches == launches    # CPU: the twin
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_prefill_span_counts_the_fused_products(monkeypatch):
    from repro_torch import api, trace

    cfg = get_config("glm4_9b", smoke=True)
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    exe = api.Accelerator(device="cpu").compile((params, cfg), (2, 24),
                                                buckets=(16,))
    prompts = torch.randint(0, cfg.vocab, (2, 11),
                            generator=torch.Generator().manual_seed(1))
    trace.clear()
    with trace.recording():
        want = exe.prefill(prompts)["logits"]
        monkeypatch.setattr(radix_lib, "fused_path",
                            _any_device(radix_lib.fused_path))
        got = exe.prefill(prompts)["logits"]
    spans = trace.spans("lm.ffn")
    trace.clear()
    n = cfg.n_layers
    assert [s.counts["fused"] for s in spans] == [0] * n + [3] * n
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only")
    return torch.device("cuda")


# GLM4-9B's gate / up and down products at a reduced, ragged M, and its
# unembed at one row a prompt (the small tile, no split), and the down
# product at decode's M = 8 (the small tile, split over K)
CARD_PRODUCTS = [(300, 4096, 13696), (300, 13696, 4096), (8, 4096, 151552),
                 (8, 13696, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", CARD_PRODUCTS)
@pytest.mark.parametrize("method", ["fused", "bitserial"])
def test_dequant_epilogue_on_the_card(card, mkn, method):
    m, k, n = mkn
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(m, k, generator=g, device=card).to(torch.bfloat16)
    w = radix_lib.kmajor_weight(radix_lib.quantize_weight(
        torch.randn(k, n, generator=g, device=card) / k ** 0.5))
    qx, sx = radix_lib._radix_activation(x, 4)
    colsum = w["qt"].sum(dim=-1, dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        d = rmm.Dequant(sx, w["scale"], colsum, 2.0 / 15, dtype)
        got = rmm.radix_matmul_cuda(qx, w["qt"], num_steps=4, method=method,
                                    kmajor=True, dequant=d)
        acc = rmm.radix_matmul_cuda(qx, w["qt"], num_steps=4, method=method,
                                    kmajor=True)
        torch.cuda.synchronize()
        assert torch.equal(got, rmm.dequantize(acc, d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", [None, "swiglu", "geglu"])
@pytest.mark.parametrize("shape", [(333, 4096), (333, 13696), (7, 1003)])
def test_one_pass_quantize_on_the_card(card, dtype, act, shape):
    g = torch.Generator(device=card).manual_seed(8)
    x, u = (torch.randn(shape, generator=g, device=card).to(DTYPES[dtype])
            for _ in range(2))
    x[1] = 0.0
    kw = {} if act is None else {"act": act, "up": u}
    h = torch.empty_like(x)
    q, s = rmm.radix_quantize_cuda(x, 4, h=h, **kw)
    h_want = torch.empty_like(x)
    want_q, want_s = rmm.radix_quantize_plain(x, 4, h=h_want, **kw)
    torch.cuda.synchronize()
    assert torch.equal(h, h_want)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_glu_over_every_finite_bf16_gate(card, act):
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    g = bits.view(torch.bfloat16).to(card)
    g = g[torch.isfinite(g)].reshape(-1, 16)
    for u in (torch.ones_like(g), torch.randn(
            g.shape, generator=torch.Generator(device=card).manual_seed(9),
            device=card).to(torch.bfloat16)):
        h = torch.empty_like(g)
        rmm.radix_quantize_cuda(g, 4, act=act, up=u, h=h)
        want = (F.silu(g) if act == "swiglu"
                else F.gelu(g, approximate="tanh")) * u
        torch.cuda.synchronize()
        diff = (h.view(torch.int16) != want.view(torch.int16)).sum()
        assert int(diff) == 0, f"{int(diff)} of {g.numel()} differ"


@pytest.mark.cuda
def test_prefill_launches_one_kernel_a_product(card, monkeypatch):
    from repro_torch import api

    cfg = dataclasses.replace(get_config("glm4_9b", smoke=True),
                              dtype="bfloat16")
    params = model.init_params(torch.Generator(device=card).manual_seed(0),
                               cfg)
    exe = api.Accelerator(dataflow="fused", device=card).compile(
        (params, cfg), (4, 64), buckets=(48,))
    prompts = torch.randint(0, cfg.vocab, (4, 37), device=card,
                            generator=torch.Generator(device=card)
                            .manual_seed(1))
    exe.prefill(prompts)                                 # warm
    before = dict(radix_lib.PRODUCTS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = exe.prefill(prompts)["logits"]
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    products = 3 * cfg.n_layers + 1
    assert sum("radix_matmul_kernel" in n for n in names) == products
    assert sum("radix_quantize_kernel" in n for n in names) == \
        2 * cfg.n_layers + 1
    assert radix_lib.PRODUCTS["fused"] == before["fused"] + products
    monkeypatch.setattr(radix_lib, "fused_path", lambda *a, **k: False)
    want = exe.prefill(prompts)["logits"]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
