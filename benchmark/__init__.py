"""The benchmark of ``pdmp3_tpu_torch``, the PyTorch and CUDA port, on one
H100: ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (``run``).  ``BENCHMARK.json`` at the checkout's
root names the cells; each configuration, traffic mix and metric is a
file of its own here (``spec``).  Importing this package imports
neither the program nor torch."""
