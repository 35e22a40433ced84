"""The port's uncompiled LM serve driver (``repro_torch.launch.serve``)
and its data source (``repro_torch.data.synthetic``) against the JAX
package's.

* ``synthetic_tokens`` equals the reference's array for array;
* ``generate`` on the RecurrentGemma-2B and RWKV-6-3B SMOKE configs,
  ``quant`` none and radix, on the CPU: its first new token equals the
  reference ``generate``'s output (which keeps only that one), and every
  later token the reference's own greedy prefill / decode loop;
* ``main`` runs on the CPU with ``--device cpu``, and raises without
  ``--device`` when there is no card;
* ``LMExecutable`` rejects the recurrent and windowed stacks naming this
  driver, as the reference's names its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_config as jget
from repro.data.synthetic import synthetic_tokens as jtokens
from repro.launch import serve as jserve
from repro.lm import model as jmodel
from repro_torch import api as tapi
from repro_torch import carry
from repro_torch.configs import get_config as tget
from repro_torch.data.synthetic import synthetic_tokens as ttokens
from repro_torch.launch import serve as tserve
from repro_torch.lm import model as tmodel

RECURRENT = ["recurrentgemma_2b", "rwkv6_3b"]


@pytest.mark.parametrize("args,kw", [
    ((0, 4, 15, 512), {}),
    ((3, 2, 40, 256_000), {}),
    ((7, 5, 9, 65_536), dict(seed=11, order=5)),
    ((1, 1, 0, 100), dict(order=1)),
])
def test_synthetic_tokens_equal_reference(args, kw):
    want, got = jtokens(*args, **kw), ttokens(*args, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _pair(arch, quant):
    kw = dict(quant=quant, radix_steps=4)
    jcfg = dataclasses.replace(jget(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(tget(arch, smoke=True), **kw)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = carry.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         tcfg)
    return (jcfg, jmodel.radixify_params(jparams, jcfg), tcfg,
            tmodel.kmajor_params(tmodel.radixify_params(tparams, tcfg)))


@pytest.mark.parametrize("quant", ["none", "radix"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_generate_matches_reference(arch, quant):
    jcfg, jparams, tcfg, tparams = _pair(arch, quant)
    prompts = ttokens(0, 2, 10, jcfg.vocab)             # (2, 11)
    s0, new = prompts.shape[1], 6
    got, logits = tserve.generate(tcfg, tparams, torch.from_numpy(prompts),
                                  new, return_logits=True)
    assert tuple(got.shape) == (2, s0 + new) and got.dtype == torch.long
    assert len(logits) == new
    np.testing.assert_array_equal(got[:, :s0].numpy(), prompts)
    want = np.asarray(jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                                      new))
    np.testing.assert_array_equal(got[:, :want.shape[1]].numpy(), want)
    # the reference's loop body, keeping every token
    last, caches = jmodel.prefill(
        jparams, {"tokens": jnp.pad(jnp.asarray(prompts), ((0, 0), (0, 1)))},
        jcfg, None, max_len=s0 + new)
    toks = [last.argmax(-1)[:, None]]
    for t in range(s0, s0 + new - 1):
        last, caches = jmodel.decode_step(jparams, caches, toks[-1],
                                          jnp.int32(t), jcfg, None)
        np.testing.assert_allclose(logits[t - s0 + 1].numpy(),
                                   np.asarray(last), rtol=2e-4, atol=2e-4)
        toks.append(last.argmax(-1)[:, None])
    np.testing.assert_array_equal(got[:, s0:].numpy(),
                                  np.concatenate(toks, axis=1))


def test_generate_sampled_is_seeded():
    _, _, tcfg, tparams = _pair("rwkv6_3b", "none")
    prompts = torch.from_numpy(ttokens(0, 2, 5, tcfg.vocab))
    draws = [tserve.generate(tcfg, tparams, prompts, 4, greedy=False,
                             generator=torch.Generator().manual_seed(3))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    with pytest.raises(ValueError, match="generator="):
        tserve.generate(tcfg, tparams, prompts, 4, greedy=False)


def test_main_runs_on_cpu(capsys):
    out = tserve.main(["--arch", "rwkv6_3b", "--smoke", "--quant", "radix",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "8", "--tokens", "3"])
    assert tuple(out.shape) == (2, 11) and out.device.type == "cpu"
    text = capsys.readouterr().out
    assert "[serve] generated (2, 11) tokens" in text
    assert "ms/token (batch 2)" in text


def test_main_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "rwkv6_3b", "--smoke", "--tokens", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_cache(tget("rwkv6_3b", smoke=True), 2, 8)


@pytest.mark.parametrize("arch", ["whisper_medium", "qwen2_vl_72b"])
def test_generate_rejects_embedding_archs(arch):
    """Token prompts cannot feed Whisper's encoder or Qwen2-VL's embedding
    inputs: ``generate`` and ``main`` name ``model.prefill`` /
    ``decode_step`` (the reference fails there with a ``KeyError``)."""
    cfg = tget(arch, smoke=True)
    prompts = torch.zeros((2, 4), dtype=torch.long)
    with pytest.raises(ValueError, match=r"model\.prefill / decode_step"):
        tserve.generate(cfg, {}, prompts, 2)
    with pytest.raises(ValueError, match=r"model\.prefill / decode_step"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jget(arch,
                                                             smoke=True))
    with pytest.raises(KeyError):
        jserve.generate(jget(arch, smoke=True), jparams,
                        jnp.zeros((2, 4), jnp.int32), 2)


@pytest.mark.parametrize("arch", RECURRENT)
def test_lm_executable_names_the_driver(arch):
    jcfg, jparams, tcfg, tparams = _pair(arch, "none")
    with pytest.raises(ValueError, match=r"repro\.launch\.serve\.generate"):
        japi.Accelerator(backend="kernels").compile((jparams, jcfg), (2, 24),
                                                    buckets=(8, 16))
    with pytest.raises(ValueError,
                       match=r"repro_torch\.launch\.serve\.generate"):
        tapi.Accelerator(device="cpu").compile((tparams, tcfg), (2, 24),
                                               buckets=(8, 16))
