"""Host milliseconds of the CNN plan a call: the mean length of the
program's ``plan.forward`` spans (``repro_torch.trace``, one a call of
the compiled plan) inside the traced window.  Silent when the window
holds another number of them than calls."""

from bench import spans


def read(t):
    got = spans.per_call(t, "plan.forward", t.info.get("calls", 0))
    if got is None:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / 1e6 / len(got)
