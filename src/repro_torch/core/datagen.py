"""Random-walk datasets, numpy only (a copy of ``repro/core/datagen.py``'s).

The paper's synthetic benchmark is a Gaussian random walk. The tests make
their inputs with this function and hand the same arrays to both packages;
``chip_smoke.py`` makes its full-size data on the card instead.
"""

from __future__ import annotations

import numpy as np


def random_walk(
    num_series: int, length: int = 256, seed: int = 0, chunk: int = 65536
) -> np.ndarray:
    """Paper's generator: steps ~ N(0,1), cumulatively summed per series."""
    rng = np.random.default_rng(seed)
    out = np.empty((num_series, length), np.float32)
    for s in range(0, num_series, chunk):
        e = min(s + chunk, num_series)
        out[s:e] = rng.standard_normal((e - s, length), np.float32).cumsum(axis=1)
    return out
