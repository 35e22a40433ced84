"""Closed loop, one client: prefill calls of ``batch`` prompts through
``LMExecutable``, each followed by the greedy first token, the steps of
``LMExecutable.generate(prompts, 1)`` with the logits kept for the check.

Each call's prompts share one length (the compiled path takes one length
per call) and pad to the single ``bucket``.  Lengths come in pairs, L
uniform on ``[length_min, length_max]`` and ``length_min + length_max -
L``, so every seed sends the same number of true tokens; the window ends
at the end of the first pair that finishes after ``seconds``.  Token ids
are uniform over the vocabulary, drawn on the device from the seed for
``calls_drawn`` calls and reused in turn beyond them.  The rate counts
true prompt tokens plus the generated ones, never the padding.

The check follows the program step by step.  Radix quantization to 2^T
levels turns a difference at a level's boundary into a whole level, and
forty layers compound it: the program and any reference that is not bit
for bit the same part ways as far as a broken program would.  So after
the window the checked calls (``check_calls`` of them: the longest, the
shortest, then others in the seed's order) run again through the same
entry with each layer's input kept, and the float32 reference
(``bench/reference/glm_prefill.py``) takes each layer from the program's
input to it: the repeated call must give the window's logits bit for
bit, the first layer's input must be the prompts' embedding, every
layer's update and the head's logits must lie within their limits of the
reference's, and each served token's reference logit within
``token_gap`` row standard deviations of the best.  One anchor does not
start from the program's state: the reference's own trajectory from the
embedding through the first ``anchor_layers`` layers, against the
program's residual stream there, relative to what those layers added."""

from __future__ import annotations

import time

import torch

from bench import traffic
from bench.harness import Check
from bench.nets import lm


class Driver:
    def __init__(self, run):
        from repro_torch import api

        self.run = run
        cfg, wl = run.config, run.workload
        self.batch, self.bucket = int(wl["batch"]), int(wl["bucket"])
        params = lm.params(cfg, run.seed, run.device)
        self.exe = api.Accelerator(
            dataflow=cfg["dataflow"], device=str(run.device)).compile(
            (params, lm.arch(cfg)), (self.batch, self.bucket + 1),
            buckets=(self.bucket,))
        del params
        self.lengths, self.tokens = calls_of(run)
        for i in range(int(wl["warm_calls"])):
            self._call(i, self.bucket)
        run.sync()
        self.calls = []
        self.elapsed = 0.0

    def _call(self, i: int, length: int):
        with self.run.span("LMExecutable.prefill"):
            state = self.exe.prefill(self.tokens[i % len(self.tokens),
                                                 :, :length])
        with self.run.span("greedy_token"):
            logits = state["logits"]
            return logits, torch.argmax(logits.to(torch.float32), dim=-1)

    def window(self) -> None:
        run = self.run
        calls = []
        run.sync()
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        while True:
            for _ in range(2):
                i = len(calls) % len(self.lengths)
                length = self.lengths[i]
                calls.append((i, length) + self._call(i, length))
            if time.perf_counter() >= deadline:
                break
        run.sync()
        self.elapsed = time.perf_counter() - t0
        self.calls = calls

    def metrics(self) -> dict:
        tokens = sum(self.batch * (length + 1) for _, length, _, _
                     in self.calls)
        return {"lm_tokens_per_s": tokens / self.elapsed}

    def attempted(self):
        return len(self.calls) * self.batch, 0

    def info(self) -> dict:
        return {"lengths": [length for _, length, _, _ in self.calls],
                "batch": self.batch, "bucket": self.bucket}

    def release(self) -> None:
        """Run the checked calls again through the same entry, keeping each
        layer's input and its attention and FFN blocks' outputs (the
        program's state the reference steps from), then free the
        program."""
        from repro_torch.lm import blocks
        from repro_torch.lm import model as lm_model

        run = self.run
        inner = (lm_model._run_layer, blocks.attention, blocks.ffn)
        self.served = []
        for j in checked([c[1] for c in self.calls], run.seed,
                         int(run.workload["check_calls"])):
            i, length, logits, token = self.calls[j]
            prompts = self.tokens[i % len(self.tokens), :, :length]
            kept = {"states": [], "attn": [], "ffn": []}

            def keep(name, t):
                kept[name].append(t[:, :length].clone())

            def run_layer(h, *args, **kwargs):
                out = inner[0](h, *args, **kwargs)
                keep("states", h)
                if len(kept["states"]) == run.config["n_layers"]:
                    keep("states", out[0])
                return out

            def attention(*args, **kwargs):
                out = inner[1](*args, **kwargs)
                keep("attn", out[0])
                return out

            def ffn(*args, **kwargs):
                out = inner[2](*args, **kwargs)
                keep("ffn", out)
                return out

            lm_model._run_layer, blocks.attention, blocks.ffn = (
                run_layer, attention, ffn)
            try:
                again = self.exe.prefill(prompts)["logits"]
            finally:
                lm_model._run_layer, blocks.attention, blocks.ffn = inner
            self.served.append(Served(prompts, logits, token, again, **kept))
        self.exe = None

    def check(self):
        return compare(self.run, self.served)


class Served:
    """One checked call: its prompts (B, L), the window's logits and
    tokens, the logits of the same call again, and from it every layer's
    input (and the last layer's output), attention block output and FFN
    block output, each (B, L, d)."""

    def __init__(self, prompts, logits, token, again, states, attn, ffn):
        self.prompts, self.logits, self.token = prompts, logits, token
        self.again, self.states, self.attn, self.ffn = (again, states, attn,
                                                        ffn)


def calls_of(run):
    """The seed's ``calls_drawn`` calls: their prompt lengths (in pairs)
    and their (calls, batch, bucket) token ids, drawn on the device."""
    wl = run.workload
    n = int(wl["calls_drawn"])
    lengths = traffic.paired_lengths(n // 2, int(wl["length_min"]),
                                     int(wl["length_max"]),
                                     traffic.rng(run.seed, 3))
    g = torch.Generator(device=run.device).manual_seed(
        traffic.sub_seed(run.seed, 4))
    tokens = torch.randint(0, run.config["vocab"],
                           (n, int(wl["batch"]), int(wl["bucket"])),
                           generator=g, device=run.device)
    return lengths, tokens


def checked(lengths, seed: int, want: int) -> list:
    """Indices of the ``want`` calls to check among calls of ``lengths``:
    the longest, the shortest, then the others in the seed's order."""
    n = len(lengths)
    ends = [max(range(n), key=lengths.__getitem__),
            min(range(n), key=lengths.__getitem__)]
    rest = traffic.rng(seed, 5).permutation(n).tolist()
    return list(dict.fromkeys(ends + rest))[:want]


def _rel(got: torch.Tensor, want: torch.Tensor, base=None) -> float:
    """The worst prompt's L2 distance (leading dim: prompts) relative to
    ``want``, or to ``want - base``."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    scale = want if base is None else want - base.to(torch.float32)
    dims = tuple(range(1, want.ndim))
    return float((torch.linalg.vector_norm(got - want, dim=dims)
                  / torch.linalg.vector_norm(scale, dim=dims)).max())


def compare(run, served, params=None) -> list:
    """The cell's checks of ``served`` calls against the reference, on
    weights drawn again from the seed: the call again repeats the
    window's logits; the first layer's input is the prompts' embedding;
    each residual sum is the program's blocks' outputs added; each
    attention block's output from the program's input to it, each FFN
    block's from the program's residual stream after attention, and the
    head's logits from the program's last state lie within their limits
    of the reference's; the served tokens' gap in the reference's
    logits; the program's residual stream after ``anchor_layers`` layers
    against the reference's own trajectory from the embedding."""
    from bench.reference import glm_prefill

    cfg, limits = run.config, run.workload["limits"]
    depth = int(run.workload["anchor_layers"])
    if params is None:
        params = lm.params(cfg, run.seed, run.device)
    ref = glm_prefill.Model(cfg, params, cfg["dtype"])
    store = ref.nm.store
    again = embed = residual = attn = ffn = head = gap = anchor = 0.0
    for c in served:
        again += float((c.again != c.logits).sum())
        states = [x.to(torch.float32) for x in c.states]
        h = start = ref.embed(c.prompts)
        embed += float((states[0] != start).sum())
        for i in range(depth):
            h = ref.layer(i, h)
        anchor = max(anchor, _rel(states[depth], h, start))
        for i in range(cfg["n_layers"]):
            a, y = c.attn[i].to(torch.float32), c.ffn[i].to(torch.float32)
            attn = max(attn, _rel(a, ref.attention(i, states[i])))
            mid = store(states[i] + a)
            ffn = max(ffn, _rel(y, ref.ffn(i, mid)))
            residual += float((states[i + 1] != store(mid + y)).sum())
        logits = ref.head(states[-1][:, -1])
        head = max(head, _rel(c.logits, logits))
        chosen = logits.gather(1, c.token[:, None])[:, 0]
        gap = max(gap, float(((logits.max(dim=-1).values - chosen)
                              / logits.std(dim=-1)).max()))
    return [Check("rerun_differing", again, 0.0),
            Check("embed_differing", embed, 0.0),
            Check("residual_differing", residual, 0.0),
            Check("attn_rel_err", attn, limits["attn_rel_err"]),
            Check("ffn_rel_err", ffn, limits["ffn_rel_err"]),
            Check("head_rel_err", head, limits["head_rel_err"]),
            Check("token_gap", gap, limits["token_gap"]),
            Check("anchor_rel_err", anchor, limits["anchor_rel_err"])]


def control(run) -> list:
    """The control in the program's place: the reference with every
    product one precision step below the configuration's (float8 e4m3
    for its bfloat16 products, int4 weights in its radix products),
    along its own states, over ``check_calls`` of the seed's
    ``calls_drawn`` calls chosen as the window's are, held to the cell's
    checks."""
    from bench.reference import glm_prefill

    cfg, wl = run.config, run.workload
    lengths, tokens = calls_of(run)
    params = lm.params(cfg, run.seed, run.device)
    low = glm_prefill.Model(cfg, params, cfg["dtype"], "lower")
    dt = low.nm.dtype

    def served():
        for j in checked(lengths, run.seed, int(wl["check_calls"])):
            prompts = tokens[j, :, :lengths[j]]
            h = low.embed(prompts)
            kept = {"states": [h.to(dt)], "attn": [], "ffn": []}
            for i in range(cfg["n_layers"]):
                a = low.attention(i, h)
                mid = low.nm.store(h + a)
                y = low.ffn(i, mid)
                h = low.nm.store(mid + y)
                kept["attn"].append(a.to(dt))
                kept["ffn"].append(y.to(dt))
                kept["states"].append(h.to(dt))
            logits = low.head(h[:, -1])
            yield Served(prompts, logits, torch.argmax(logits, dim=-1),
                         logits, **kept)

    return compare(run, served(), params)
