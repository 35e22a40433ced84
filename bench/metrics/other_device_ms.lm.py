"""Device milliseconds per prefill call of every device operation that is
not ``radix_matmul`` (the LM glue: activation quantize, weight column
sums, norms, RoPE, the bfloat16 projections and the chunked attention)."""


def read(t):
    n = len(t.info.get("lengths", []))
    if not n:
        return None
    other = sum(d for name, _, d in t.kernels
                if "radix_matmul_kernel" not in name)
    return other / 1e3 / n
