#!/usr/bin/env python3
"""Time the port's host-bound single-query paths against another tree of it.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 compare_launch_path.py --baseline OTHER [--seed 0] \\
        [--log2-n 24] [--queries 8]

``OTHER`` is the root of another checkout of the repository (for example
``git archive d847d19`` unpacked into ``.baseline/``, which ``.gitignore``
lists); its ``src/repro_torch`` builds its own kernels. Both packages are
named ``repro_torch``, so each side runs in a process of its own, in turns:
baseline, this tree, this tree, baseline. Each process builds
``chip_smoke.py``'s full-size index from ``--seed`` (N = 2**log2_n random
walks, n = 256, w = 16) and its first queries, answers every query once
untimed, then times on the host clock around a synchronised call:

  * ``nb_exact_search`` (16 workers, 4096-row rounds: 1024 rounds at 2^24,
    each one ``euclid_sq`` launch and a few small tensor operations, so
    bound by the host), ms a query;
  * ``exact_knn`` at k = 5 (the classifier's Q = 1 engine), ms a query;
  * the launch path alone: ``euclid_sq_gather`` (16 queries x 64 rows) and
    ``lower_bound_sq`` (2^12 rows), kernels of a few microseconds, each
    called :data:`LAUNCHES` times back to back and timed without a
    synchronisation between calls, us a call: the wrapper's host time.

The answers must be the same on both sides (positions equal, distances
bitwise). The last lines are the card's name and power limit as
``nvidia-smi`` gives them, then a JSON object of every turn's numbers.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
LAUNCHES = 2000  # calls a launch-path timing
K = 5  # the classifier's k


def worker(tree: str, seed: int, log2_n: int, n_q: int) -> dict:
    """One side's timings (runs in a process of its own)."""
    sys.path.insert(0, str(pathlib.Path(tree) / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.core import SearchConfig, build_index, isax
    from repro_torch.core.search import exact_knn, nb_exact_search
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    index = build_index(cs.random_walks(1 << log2_n, 256, gen, dev),
                        device=dev)
    queries = cs.random_walks(n_q, 256, gen, dev)
    cfg = SearchConfig()

    def timed(fn):
        out, times = [], []
        for q in queries:
            fn(q)  # untimed: kernels built and loaded, caches warm
        for q in queries:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(q)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            out.append(res)
        return out, times

    nb, nb_ms = timed(lambda q: nb_exact_search(index, q, cfg))
    knn, knn_ms = timed(lambda q: exact_knn(index, q, k=K))

    def per_call_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAUNCHES):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * host / LAUNCHES

    qz = isax.znorm(queries[:1]).expand(16, -1).contiguous()
    pos = index.pos[:16 * 64].reshape(16, 64).contiguous()
    bpp = isax.padded_breakpoints(index.cardinality, dev)
    qp = isax.paa(qz[0], index.segments)
    sax = index.sax[:1 << 12]
    return dict(
        nb_exact_search_ms=nb_ms, exact_knn_ms=knn_ms,
        euclid_sq_us=per_call_us(
            lambda: ops.euclid_sq_gather(qz, index.raw, pos)),
        lower_bound_sq_us=per_call_us(
            lambda: ops.lower_bound_sq(qp, sax, bpp, 256)),
        nb=[(r.dist_sq.item(), int(r.position)) for r in nb],
        knn=[(d.tolist(), p.tolist()) for d, p in knn])


def main(argv=None) -> int:
    """Run the two trees in turns (baseline, this, this, baseline); print
    every turn's numbers."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2-n", type=int, default=24)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.seed, args.log2_n,
                                args.queries)))
        return 0
    if not args.baseline:
        ap.error("--baseline is required")
    sides = {"baseline": str(pathlib.Path(args.baseline).resolve()),
             "change": str(ROOT)}
    turns = []
    for side in ("baseline", "change", "change", "baseline"):
        run = subprocess.run(
            [sys.executable, __file__, "--worker", sides[side],
             "--seed", str(args.seed), "--log2-n", str(args.log2_n),
             "--queries", str(args.queries)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if run.returncode:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{side} worker failed ({run.returncode})")
        got = json.loads(run.stdout.strip().splitlines()[-1])
        got["side"] = side
        turns.append(got)
        print(f"{side}: nb_exact_search "
              f"{statistics.mean(got['nb_exact_search_ms']):.3f} ms, "
              f"exact_knn {statistics.mean(got['exact_knn_ms']):.3f} ms a "
              f"query; launch path euclid_sq {got['euclid_sq_us']:.2f} us, "
              f"lower_bound_sq {got['lower_bound_sq_us']:.2f} us a call",
              flush=True)
    for t in turns[1:]:
        if t["nb"] != turns[0]["nb"] or t["knn"] != turns[0]["knn"]:
            raise SystemExit(f"{t['side']}'s answers differ from the "
                             "baseline's")
    print("answers: equal on both sides in every turn")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "turns": [
        {k: v for k, v in t.items() if k not in ("nb", "knn")}
        for t in turns]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
