"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no
sparsity), at the full 700 W power limit.  A card set below it runs
slower; the harness reports ``nvidia-smi``'s ``power.limit`` beside every
share of these peaks."""

INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
