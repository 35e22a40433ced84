"""The yardstick's arithmetic and the traffic generator."""

import json
from pathlib import Path

import pytest

from bench import traffic
from bench.work import gemm, models, peaks

BENCH = Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_vgg11_macs_at_224():
    macs = models.vgg_macs(config("vgg11-radix4"))
    assert round(macs["conv"] / 1e9, 3) == 7.485
    assert round(macs["linear"] / 1e9, 3) == 0.124
    assert macs["linear"] == 25088 * 4096 + 4096 * 4096 + 4096 * 1000
    assert models.vgg_ops(config("vgg11-radix4")) == 2.0 * (
        macs["conv"] + macs["linear"])


def test_vgg_calls_are_the_plans_launches():
    cfg = config("vgg11-radix4")
    calls = models.vgg_calls(cfg, 64)
    assert [c.kernel for c in calls] == ["radix_conv2d"] * 8 \
        + ["radix_matmul"] * 3
    first = calls[0]
    # 64 x 224 x 224 rows, K = 27, N = 64; the input padded to 226 x 226
    assert first.ops == 2.0 * 64 * 224 * 224 * 27 * 64
    assert first.nbytes == (64 * 226 * 226 * 3 + 27 * 64 + 512
                            + 64 * 224 * 224 * 64 + 8 * 64)
    assert sum(c.ops for c in calls) == 64 * models.vgg_ops(cfg)
    logits = calls[-1]          # int32 out, no epilogue rows
    assert logits.nbytes == 64 * 4096 + 4096 * 1000 + 512 + 64 * 1000 * 4


def test_least_time_is_the_larger_bound():
    c = gemm.gemm("radix_matmul", 8, 4096, 4096, x_bytes=8 * 4096,
                  epilogue=False, occupancy=False)
    assert c.least_s == c.nbytes / peaks.HBM_BYTES_PER_S  # bytes bound
    c = gemm.gemm("radix_matmul", 16384, 4096, 13696, x_bytes=16384 * 4096,
                  epilogue=False, occupancy=False)
    assert c.least_s == c.ops / peaks.INT8_OPS_PER_S      # operations bound


def test_lm_prefill_counts():
    cfg = config("glm4-9b-radix4")
    calls = models.lm_prefill_calls(cfg, 8, 2048)
    assert len(calls) == 40 * 3 + 1
    assert calls[-1].ops == 2.0 * 8 * 4096 * 151552
    ops = models.lm_prefill_ops(cfg, 1)
    assert ops["int8"] == 2.0 * 3 * 4096 * 13696 * 40 + 2.0 * 4096 * 151552
    proj = 2.0 * (2 * 4096 * 4096 + 2 * 4096 * 256) * 40
    assert ops["bf16"] == proj + 2.0 * 2 * 32 * 128 * 1 * 40
    # attention grows with the square of the length, the rest linearly
    a, b = models.lm_prefill_ops(cfg, 1000), models.lm_prefill_ops(cfg, 2000)
    assert b["int8"] - ops["int8"] == 2 * (a["int8"] - ops["int8"]) + (
        ops["int8"] - 2.0 * 4096 * 151552) * 1
    assert b["bf16"] > 2 * a["bf16"]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 40 + 3])
def test_paired_lengths_repeat_and_sum(seed):
    a = traffic.paired_lengths(48, 1025, 2048, traffic.rng(seed, 3))
    b = traffic.paired_lengths(48, 1025, 2048, traffic.rng(seed, 3))
    assert a == b
    assert all(1025 <= x <= 2048 for x in a)
    assert all(x + y == 3073 for x, y in zip(a[::2], a[1::2]))
    other = traffic.paired_lengths(48, 1025, 2048, traffic.rng(seed + 1, 3))
    assert other != a and sum(other) == sum(a)
