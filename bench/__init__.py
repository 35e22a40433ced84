"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell: set-up, warm-up, a measured window, the output check
against the plain references under ``bench/reference``, and one JSON
result line.  What belongs to one configuration, traffic mix, driver or
per-layer metric lives in a file of its own (``configs/``,
``workloads/``, ``drivers/``, ``metrics/``), found by name.
"""
