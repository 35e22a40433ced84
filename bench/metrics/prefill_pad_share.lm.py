"""Share of the prefill's computed positions that are padding: 1 - the
true tokens (prompts x prompt length) over the positions computed
(batch x bucket), summed over the program's ``lm.prefill`` spans
(``repro_torch.trace``, one a call) inside the traced window.  Silent
when the window holds another number of them than calls."""

from bench import spans


def read(t):
    got = spans.per_call(t, "lm.prefill", len(t.info.get("lengths", [])))
    if got is None:
        return None
    true = sum(s.counts["true_tokens"] for s in got)
    return 100.0 * (1.0 - true / sum(s.counts["tokens"] for s in got))
