"""Host milliseconds a call of the CNN plan's plane-occupancy prepass:
the program's ``plan.occupancy`` spans (one a conv or linear layer a
call) inside the traced window, summed over a call.  Silent when the
window holds another number of them than the plan's kernel layers over
the calls made."""

from bench import spans
from bench.work import models


def read(t):
    calls = t.info.get("calls", 0)
    layers = len(models.vgg_calls(t.config, t.info.get("batch", 1)))
    got = spans.per_call(t, "plan.occupancy", calls, layers)
    if got is None:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / 1e6 / calls
