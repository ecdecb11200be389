"""Paper Fig. 18 use case: a k-NN time-series classifier backed by ParIS+.

The port of ``examples/knn_classifier.py``: two synthetic classes of random
walks (opposite drift); the classifier finds each query's k nearest indexed
series with the index's exact search and votes, and the full scan votes
beside it:

    PYTHONPATH=src python -m repro_torch.examples.knn_classifier
        [--device cpu] [--per-class 20000] [--length 128] [--trials 20]

It runs on the card unless ``--device cpu`` is given, and exits 1 if the
index's vote ever differs from the full scan's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import build_index
from repro_torch.core.classifier import KnnClassifier
from repro_torch.core.device import resolve_device


def _clock(dev: torch.device) -> float:
    """The host clock once the device has finished its work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def main(argv=None) -> bool:
    """Index, classify, print; True when every vote agreed with the scan's."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--per-class", type=int, default=20_000)
    ap.add_argument("--length", type=int, default=128)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--k", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n_per, length = args.per_class, args.length
    print("generating two drift classes ...")
    a = (rng.standard_normal((n_per, length)) + 0.06).cumsum(axis=1)
    b = (rng.standard_normal((n_per, length)) - 0.06).cumsum(axis=1)
    raw = np.concatenate([a, b]).astype(np.float32)
    labels = np.concatenate([np.zeros(n_per, np.int32),
                             np.ones(n_per, np.int32)])

    print(f"indexing on {dev} ...")
    index = build_index(raw, device=dev)
    clf = KnnClassifier(index, labels, k=args.k)

    correct = agree = 0
    idx_ms = brute_ms = 0.0
    for _ in range(args.trials):
        drift = rng.choice([-0.06, 0.06])
        q = (rng.standard_normal(length) + drift).cumsum().astype(np.float32)
        t0 = _clock(dev)
        pred = clf.predict(q)
        idx_ms += (_clock(dev) - t0) * 1e3
        t0 = _clock(dev)
        ref = clf.predict_brute(q)
        brute_ms += (_clock(dev) - t0) * 1e3
        agree += pred == ref
        correct += (pred == (drift > 0) * 1) and (pred == ref)
    trials = args.trials
    print(f"accuracy(+agreement with brute force): {correct}/{trials}")
    print(f"agreement with brute force: {agree}/{trials}")
    print(f"mean latency: index {idx_ms / trials:.1f}ms vs "
          f"brute {brute_ms / trials:.1f}ms "
          f"({brute_ms / max(idx_ms, 1e-9):.1f}x)")
    return agree == trials


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
