"""Quickstart: build a ParIS+ index and answer exact 1-NN queries.

The port of ``examples/quickstart.py``: random walks built into an index
by the ParIS+ staged pipeline (``paa_isax`` on the card), then queries
answered by ``exact_search`` (the ``lower_bound_sq_batch`` and ``euclid_sq``
kernels) and held against the ``brute_force`` scan (``euclid_min``):

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
        [--series 100000] [--length 256] [--queries 5]

It runs on the card unless ``--device cpu`` is given, and exits 1 if any
answer differs from the scan's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (PipelineBuilder, SearchConfig, SeriesSource,
                              brute_force, exact_search, random_walk)
from repro_torch.core.device import resolve_device


def _clock(dev: torch.device) -> float:
    """The host clock once the device has finished its work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def main(argv=None) -> bool:
    """Build, query, print; True when every answer matched the scan's."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--series", type=int, default=100_000)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--queries", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=16384,
                    help="series a pipeline chunk")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, length = args.series, args.length
    print(f"generating {n} random-walk series of length {length} ...")
    raw = random_walk(n, length, seed=0)

    print(f"building the index through the ParIS+ staged pipeline on {dev} "
          "...")
    index, stats = PipelineBuilder(mode="paris+", n_workers=4,
                                   device=dev).build(
        SeriesSource.from_array(raw, chunk_series=args.chunk))
    print(f"  built in {stats.total_time:.2f}s "
          f"(read {stats.read_time:.2f}s, convert {stats.convert_time:.2f}s,"
          f" construct {stats.construct_time:.3f}s,"
          f" overlap {stats.overlap_efficiency:.0%})")
    print(f"  {index.num_series} series, {index.num_buckets} root buckets")

    rng = np.random.default_rng(7)
    all_ok = True
    for i in range(args.queries):
        q = rng.standard_normal(length).cumsum().astype(np.float32)
        t0 = _clock(dev)
        res = exact_search(index, q, SearchConfig())
        t_idx = _clock(dev) - t0
        t0 = _clock(dev)
        ref = brute_force(index, q)
        t_brute = _clock(dev) - t0
        ok = int(res.position) == int(ref.position)
        all_ok &= ok
        print(f"query {i}: 1-NN at offset {int(res.position)} "
              f"dist={float(res.dist_sq) ** 0.5:.3f} "
              f"reads={int(res.raw_reads)}/{n} "
              f"({t_idx * 1e3:.1f}ms vs brute {t_brute * 1e3:.1f}ms) "
              f"exact={ok}")
    return all_ok


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
