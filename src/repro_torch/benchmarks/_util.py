"""Helpers the port's benchmarks share (copies of the reference's
``benchmarks/_util.py::bench_rng`` and ``csv_row``)."""
from __future__ import annotations

import os

import numpy as np


def bench_rng(offset: int = 0) -> np.random.Generator:
    """Seeded RNG for benchmark inputs: ``REPRO_TEST_SEED`` (default 0)
    plus ``offset``, as the reference's, so both packages draw the same
    inputs under one seed."""
    seed = int(os.environ.get("REPRO_TEST_SEED", "0"))
    return np.random.default_rng(seed + offset)


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"
