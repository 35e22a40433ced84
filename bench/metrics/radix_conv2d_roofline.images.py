"""``radix_conv2d``'s share of its roofline: the least time of its calls
in the traced window (each the larger of its operations over the int8
peak and its bytes over the HBM bandwidth, ``bench.work.gemm``) over the
kernel's device time.  Silent when the trace holds another number of
launches than the plan's convs over the calls made."""

from bench.work import models


def read(t):
    secs, launches = t.kernel("radix_conv2d_kernel")
    calls = [c for c in models.vgg_calls(t.config, t.info["batch"])
             if c.kernel == "radix_conv2d"]
    if not launches or launches != len(calls) * t.info["calls"]:
        return None
    return 100.0 * sum(c.least_s for c in calls) * t.info["calls"] / secs
