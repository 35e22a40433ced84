"""Device milliseconds a prefill call of the LM's attention blocks: the
CUDA-event times of the program's ``lm.attention`` spans
(``repro_torch.trace``, one a layer a call: projections, RoPE, the
chunked attention) inside the traced window, summed over a call.  Silent
when the window holds another number of them than layers over calls,
or on the CPU, where spans have no device time."""

from bench import spans


def read(t):
    return spans.device_ms_per_call(t, "lm.attention")
