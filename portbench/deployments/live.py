"""Deployment ``live``: the live store, ``repro_torch.core.ingest.
MutableIndex``, built through its normal path: ``build_index`` over the
collection's first rows as the base, then appends in file order, each
followed by ``maybe_compact`` under the configuration's
``CompactionPolicy``. So its tiers (base, runs, deltas) and their global
file positions are those of a store that took the collection as a stream.

A configuration gives ``layout`` in parts of ``num_series // parts`` rows:
``base_parts`` in the base, then ``appends`` appends of one part, the last
taking any remainder. ``components`` gives the tiers the folds must leave,
in the same parts (the remainder on the last one); a store that holds
anything else is refused before the window.
"""

from __future__ import annotations

from repro_torch.core import index as paris_index
from repro_torch.core.ingest import CompactionPolicy, MutableIndex


class Handle:
    """The built store; ``close`` frees it."""

    def __init__(self, store: MutableIndex):
        self.store = store

    def stats(self) -> dict:
        """The store's counters (``MutableIndex.stats``)."""
        return self.store.stats()

    def close(self) -> None:
        """Drop the store (its components and packed view)."""
        self.store = None


def part_rows(cfg: dict) -> int:
    """Rows of one part of the layout."""
    lay = cfg["layout"]
    if lay["parts"] != lay["base_parts"] + lay["appends"]:
        raise ValueError(f"layout {lay}: parts != base_parts + appends")
    return int(cfg["num_series"]) // int(lay["parts"])


def appends(cfg: dict) -> list:
    """Rows of each append, in order; the last takes the remainder."""
    part, lay = part_rows(cfg), cfg["layout"]
    sizes = [part] * int(lay["appends"])
    sizes[-1] += int(cfg["num_series"]) - part * int(lay["parts"])
    return sizes


def expected_tiers(cfg: dict) -> dict:
    """Rows of the base, each run and each delta the folds must leave."""
    part, comp = part_rows(cfg), cfg["components"]
    want = dict(base=[part * comp["base_parts"]],
                runs=[part * p for p in comp["run_parts"]],
                deltas=[part * p for p in comp["delta_parts"]])
    want["deltas"][-1] += (int(cfg["num_series"])
                           - sum(map(sum, want.values())))
    return want


def tiers(store: MutableIndex) -> dict:
    """Rows of the store's base, each run and each delta, in file order."""
    snap = store.snapshot()
    return dict(base=[snap.base.num_series],
                runs=[r.num_series for r in snap.runs],
                deltas=[d.num_series for d in snap.deltas])


def deploy(cfg: dict, raw, device) -> Handle:
    """Build the store over the (N, n) raw series ``raw`` on ``device``.

    Every component holds its own z-normed copy of its rows, so the store
    keeps nothing of ``raw``.
    """
    base_rows = part_rows(cfg) * int(cfg["layout"]["base_parts"])
    base = paris_index.build_index(
        raw[:base_rows], segments=int(cfg["segments"]),
        cardinality=int(cfg["cardinality"]), device=device)
    store = MutableIndex(base, device=device)
    del base
    policy = CompactionPolicy(**cfg["policy"])
    at = base_rows
    for rows in appends(cfg):
        store.append(raw[at:at + rows])
        store.maybe_compact(policy)
        at += rows
    want, got = expected_tiers(cfg), tiers(store)
    if got != want:
        raise RuntimeError(f"the store holds tiers of {got} rows; the "
                           f"configuration expects {want}")
    return Handle(store)
