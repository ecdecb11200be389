"""Loop ``closed_single``: one client sends one query at a time through
``repro_torch.core.search.exact_search_single`` (the paper's ParIS+
one-query algorithm), each after the last was answered.

End to end: ``single_query_p95_ms``, the 95th percentile (nearest rank) of
every query's latency in the window: the host clock from the call to the
answer on the device, synchronised.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import search

from portbench.loops import Outcome, nearest_rank
from portbench.tracing import sync


def _call(handle, cfg, q):
    return search.exact_search_single(handle.index, q, search.SearchConfig(
        round_size=int(cfg["round_size"]), leaf_cap=int(cfg["leaf_cap"])))


def warm(handle, cfg, traffic, queries, tracer) -> None:
    """Three queries from the end of the pool."""
    for j in (1, 2, 3):
        _call(handle, cfg, queries[-j])
    sync(queries.device)


def run(handle, cfg, traffic, queries, seconds, seed, tracer) -> Outcome:
    """Queries one at a time until ``seconds`` have passed."""
    dev = queries.device
    pool = queries.shape[0]
    lat, outs = [], []
    sync(dev)
    t0 = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        with tracer.span("portbench.single"):
            res = _call(handle, cfg, queries[i % pool])
            sync(dev)
        lat.append(time.perf_counter() - t)
        outs.append((res.dist_sq, res.position))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    dists = torch.stack([d for d, _ in outs]).reshape(-1, 1).cpu().numpy()
    pos = torch.stack([p for _, p in outs]).reshape(-1, 1).long().cpu()
    return Outcome(
        ids=np.arange(i) % pool, dists=dists, pos=pos.numpy(),
        answered=np.ones(i, bool),
        metrics={"single_query_p95_ms": 1e3 * nearest_rank(lat, 95)},
        counters=dict(queries=i, window_s=window))
