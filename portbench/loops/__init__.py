"""Window drivers, one module a kind of loop, named by a traffic mix's
``"loop"``. Each has ``warm(handle, cfg, traffic, queries, tracer)``, which
runs the cell's own shapes once in set-up, and ``run(handle, cfg, traffic,
queries, seconds, seed, tracer)``, which drives the window and returns an
``Outcome``."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Outcome:
    """What one window did.

    ``ids`` holds the query (a row of the query pool) of each request of the
    window, in order; ``dists`` and ``pos`` its (k,) answer (inf and -1
    where none came); ``answered`` whether one came. ``metrics`` holds the
    end-to-end metrics this loop measures, ``counters`` what the per-layer
    readers take.
    """
    ids: np.ndarray
    dists: np.ndarray
    pos: np.ndarray
    answered: np.ndarray
    metrics: dict
    counters: dict

    @property
    def attempted(self) -> int:
        """Requests of the window."""
        return int(self.ids.shape[0])

    @property
    def failed(self) -> int:
        """Requests of the window that got no answer."""
        return int((~self.answered).sum())


def nearest_rank(values, pct: float) -> float:
    """The ``pct`` percentile by nearest rank (inf counts as a value)."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        return math.inf
    return float(v[max(0, math.ceil(pct / 100.0 * v.size) - 1)])
