"""The comparison that decides ``correct`` for exact k-NN answers.

Three numbers, each with its limit from the configuration's ``limits``:

- ``missing``: requests of the window that never got an answer or failed
  (limit 0: an exact count);
- ``dist_gap``: the largest relative gap between a distance the program
  returned and the reference's distance of the same rank,
  |d_prog - d_ref| / d_ref;
- ``pos_gap``: the largest relative gap between the reference's own
  distance to a position the program returned and the reference's
  distance of that rank. A position outside the collection, or one listed
  twice for a query, reads inf.

Ranks are compared one to one: the program's j-th answer against the
reference's j-th. An answer whose distance is right but whose series is
not at that distance fails ``pos_gap``.
"""

from __future__ import annotations

import numpy as np

TINY = 1e-30  # floor of a reference distance in a relative gap


def _rel(a: np.ndarray, ref: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    if a.size == 0:
        return 0.0
    gap = np.abs(a - ref) / np.maximum(ref, TINY)
    gap = np.where(np.isfinite(a) & np.isfinite(ref), gap, np.inf)
    gap = np.where(np.isinf(a) & np.isinf(ref), 0.0, gap)
    return float(gap.max())


def _duplicates(pos: np.ndarray) -> np.ndarray:
    """(Q, k) mask of positions already listed earlier in their row."""
    pos = np.asarray(pos)
    dup = np.zeros(pos.shape, bool)
    for j in range(1, pos.shape[1]):
        dup[:, j] = (pos[:, :j] == pos[:, j:j + 1]).any(axis=1)
    return dup


def numbers(prog_d, prog_p, ref_d, probe_d, missing: int) -> dict:
    """The compared numbers of one run's sample (host arrays, (Q, k))."""
    probe_d = np.where(_duplicates(prog_p), np.inf,
                       np.asarray(probe_d, np.float64))
    return {"missing": int(missing),
            "dist_gap": _rel(prog_d, ref_d),
            "pos_gap": _rel(probe_d, ref_d)}


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its limit."""
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in ("missing", "dist_gap", "pos_gap")}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
