"""``radix_matmul``'s share of its roofline at the prefill's shapes: the
least time of the radix products of every call in the traced window (the
padded batch x bucket rows a layer's gate, up and down products, and the
unembed over one row a prompt) over the kernel's device time.  Silent
when the trace holds another number of launches."""

from bench.work import models


def read(t):
    secs, launches = t.kernel("radix_matmul_kernel")
    calls = models.lm_prefill_calls(t.config, t.info["batch"],
                                    t.info["bucket"])
    n = len(t.info["lengths"])
    if not launches or launches != len(calls) * n:
        return None
    return 100.0 * sum(c.least_s for c in calls) * n / secs
