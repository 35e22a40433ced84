"""The whole prefill's share of the chip's peaks: the model operations of
the true tokens (``bench.work.models.lm_prefill_ops``), each precision at
its own dense peak (int8 radix products at 1,979 TOP/s, bfloat16
projections and causal attention at 989 TFLOP/s), summed as least times,
over the traced window."""

from bench.work import models, peaks


def read(t):
    if not t.info.get("lengths"):
        return None
    least = 0.0
    for length in t.info["lengths"]:
        ops = models.lm_prefill_ops(t.config, length)
        least += t.info["batch"] * (ops["int8"] / peaks.INT8_OPS_PER_S
                                    + ops["bf16"] / peaks.BF16_FLOPS_PER_S)
    return 100.0 * least / t.window_s
