"""Loop ``closed_batch``: one client sends batches of ``batch`` queries back
to back through ``repro_torch.core.search.exact_knn_batch``, each after the
last was answered, for the whole window.

End to end: ``queries_per_s``, every query answered in the window over the
window's time. Counters: batches, queries, and the engine's reads
(``stats=True``), which the per-layer readers take.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import search

from portbench.loops import Outcome
from portbench.tracing import sync


def _call(handle, cfg, traffic, qs):
    return search.exact_knn_batch(
        handle.index, qs, k=int(traffic["k"]),
        round_size=int(cfg["round_size"]), leaf_cap=int(cfg["leaf_cap"]),
        stats=True)


def _batches(queries, b: int) -> int:
    return queries.shape[0] // b


def warm(handle, cfg, traffic, queries, tracer) -> None:
    """Two batches at the window's shape, from the end of the pool."""
    b = int(traffic["batch"])
    nb = _batches(queries, b)
    for j in (nb - 1, nb - 2):
        _call(handle, cfg, traffic, queries[j * b:(j + 1) * b])
    sync(queries.device)


def run(handle, cfg, traffic, queries, seconds, seed, tracer) -> Outcome:
    """Batches back to back until ``seconds`` have passed."""
    b = int(traffic["batch"])
    nb = _batches(queries, b)
    outs, reads, rounds, times = [], [], [], []
    sync(queries.device)
    t0 = time.perf_counter()
    i = 0
    while True:
        j = i % nb
        t = time.perf_counter()
        with tracer.span("portbench.batch"):
            d, p, r, _, n_rounds = _call(handle, cfg, traffic,
                                         queries[j * b:(j + 1) * b])
        now = time.perf_counter()
        outs.append((j, d, p))
        reads.append(r)
        rounds.append(n_rounds)
        times.append(now - t)
        i += 1
        if now - t0 >= seconds:
            break
    with tracer.span("portbench.sync"):
        sync(queries.device)
    window = time.perf_counter() - t0
    n_q = i * b
    ids = np.concatenate([np.arange(j * b, (j + 1) * b) for j, _, _ in outs])
    dists = torch.cat([d for _, d, _ in outs]).cpu().numpy()
    pos = torch.cat([p for _, _, p in outs]).long().cpu().numpy()
    total_reads = int(torch.stack([x.sum(dtype=torch.int64)
                                   for x in reads]).sum())
    return Outcome(
        ids=ids, dists=dists, pos=pos, answered=np.ones(n_q, bool),
        metrics={"queries_per_s": n_q / window},
        counters=dict(batches=i, queries=n_q, reads=total_reads,
                      batch=b, window_s=window, rounds=sum(rounds),
                      rounds_max=max(rounds), batch_s_max=max(times)))
