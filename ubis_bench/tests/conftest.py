"""Shared pieces of the benchmark's own tests (run them with
``PYTHONPATH=src python -m pytest ubis_bench/tests``; the repository's
suite does not collect them)."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: every cell at a size the CPU runs in seconds, through the kernels'
#: plain versions
SMALL = {
    "config": {"data": {"n": 2000, "clusters": 8},
               "index": {"max_postings": 256, "cache_capacity": 256,
                         "max_ids": 1 << 15},
               "driver": {"round_size": 256, "bg_ops_per_round": 8,
                          "drain_per_tick": 256},
               "load": {"chunk": 1000, "ticks_max": 64}},
    "traffic": {"fresh": 256, "deletes": 256, "queries": 48, "batches": 2,
                "recall_sample": 16, "ticks_max": 4},
}
SEED = 2**31 + 11


def run_small(cell: str, *, trace: bool = False, seconds: float = 1.0,
              root: Path = ROOT, traffic: dict = None, **kw) -> dict:
    """One run of ``cell`` at the small size (``traffic``: further
    parameters of the mix)."""
    from ubis_bench import harness
    small = {**SMALL, "traffic": {**SMALL["traffic"], **(traffic or {})}}
    spec = harness.load_spec(root, cell, trace, small)
    return harness.run_cell(spec, seed=SEED, seconds=seconds, trace=trace,
                            device="cpu", t_start=time.perf_counter(), **kw)


@pytest.fixture
def card():
    """The CUDA card, or a skip where this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
