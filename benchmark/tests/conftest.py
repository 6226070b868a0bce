"""Tiny cells for the benchmark's CPU tests: a few slots, few streams,
the plain PyTorch versions of the port's kernels."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"pool": {"slots": 8, "parse_threads": 1},
        "distinct": 3,
        "watch": {"sources": 2, "slots_per_source": 3},
        "warmup_steps": 1}

WORKLOADS = ("mp3_44k1_128k_js_fast.backend",
             "mpeg2_lsf_22k05_64k_exact.backend")


@pytest.fixture
def tiny_run():
    """run(workload, seed, **kw) -> the result line of a tiny CPU run."""
    import time

    import torch

    from benchmark import spec
    from benchmark.run import run_cell

    def run(workload, seed=987654321012, seconds=0.3, **kw):
        cell = spec.cell(workload)
        return run_cell(cell, seed, seconds, False, torch.device("cpu"),
                        time.perf_counter(), TINY, **kw)
    return run
