"""Reusable hillclimb drivers: lattice search + the dry-run variant sweep.

Counterpart of ``repro/launch/hillclimb.py``, both halves:

  * :func:`snap_to_lattice` and :func:`coordinate_descent` — the greedy
    lattice search the kernel autotuner (``repro_torch.core.tuning``) runs
    over launch shapes, copied as it is, so the two tuners take the same
    steps on the same cost surface: one axis at a time, step to a
    neighbour only when it wins by more than ``min_gain`` (the noise
    floor), repeat until no axis improves;
  * :data:`VARIANTS`, :func:`show`, :func:`run_variants` and :func:`main`
    — the dry-run variant sweep: tagged variants of three cells, each
    traced by ``launch/dryrun.py`` and printed beside the cell's baseline
    record as roofline terms on the H100.

Importing this module imports nothing else; :func:`run_variants` imports
the dry-run when it runs.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Sequence, Tuple


def snap_to_lattice(value: int, lattice: Sequence[int]) -> int:
    """Nearest lattice point to ``value`` (ties break toward the smaller)."""
    return min(lattice, key=lambda x: (abs(x - value), x))


def coordinate_descent(
    evaluate: Callable[[Dict[str, int]], float],
    start: Dict[str, int],
    axes: Dict[str, Sequence[int]],
    *,
    min_gain: float = 0.03,
    max_steps: int = 64,
) -> Tuple[Dict[str, int], float, List[Tuple[Dict[str, int], float]]]:
    """Greedy hillclimb over a product lattice of per-axis candidates.

    ``evaluate(params) -> cost`` (lower is better). From ``start`` (snapped
    onto the lattice), repeatedly try each axis' immediate lattice
    neighbours, in the order the axis lists them, and move to a candidate
    only when it improves the best cost by more than ``min_gain``
    (relative): the threshold keeps a noisy timer (or one for which a knob
    is dead, as on the CPU) from wandering off the defaults. Every
    evaluation is cached, so revisiting a point is free.

    Returns ``(best_params, best_cost, history)``, where history is every
    distinct evaluation in order; the autotuner records ``len(history)``
    as its search cost.
    """
    cur = {k: snap_to_lattice(v, axes[k]) for k, v in start.items()}
    seen: Dict[tuple, float] = {}
    history: List[Tuple[Dict[str, int], float]] = []

    def cost_of(params: Dict[str, int]) -> float:
        key = tuple(sorted(params.items()))
        if key not in seen:
            seen[key] = float(evaluate(dict(params)))
            history.append((dict(params), seen[key]))
        return seen[key]

    best = cost_of(cur)
    for _ in range(max_steps):
        improved = False
        for name, lattice in axes.items():
            i = list(lattice).index(cur[name])
            for j in (i - 1, i + 1):
                if not 0 <= j < len(lattice):
                    continue
                cand = dict(cur, **{name: lattice[j]})
                c = cost_of(cand)
                if c < best * (1.0 - min_gain):
                    cur, best, improved = cand, c, True
        if not improved:
            break
    return cur, best, history


# --------------------------------------------------------------------------
# The dry-run variant sweep (the reference's ``VARIANTS``, verbatim).
# Cells (the reference's choice from its baseline table):
#   * olmoe-1b-7b/train_4k — the global MoE dispatch's collectives;
#   * granite-34b/train_4k — the dense model's memory term and peak;
#   * paris/search — the paper's own technique on the pod.
# Each variant is one hypothesis -> change -> re-trace -> re-count cycle.

VARIANTS = [
    # --- olmoe train: kill the dispatch all-reduce ---
    ("olmoe-1b-7b", "train_4k", "opt1_local_dispatch",
     dict(overrides={"moe_dispatch": "local"})),
    ("olmoe-1b-7b", "train_4k", "opt2_local_plus_dense_attn",
     dict(overrides={"moe_dispatch": "local",
                     "attn_dense_threshold": 4096})),
    ("olmoe-1b-7b", "train_4k", "opt3_local_dense_mb4",
     dict(overrides={"moe_dispatch": "local",
                     "attn_dense_threshold": 4096},
          build_kwargs=dict(microbatch_tokens_per_device=16384))),
    # --- granite train: dense attention + sequence-parallel activations ---
    ("granite-34b", "train_4k", "opt1_dense_attn",
     dict(overrides={"attn_dense_threshold": 4096})),
    ("granite-34b", "train_4k", "opt2_dense_attn_seqshard",
     dict(overrides={"attn_dense_threshold": 4096},
          build_kwargs=dict(logical_overrides={"seq": "model"},
                            microbatch_tokens_per_device=65536))),
    ("granite-34b", "train_4k", "opt3_dense_seqshard_mb2",
     dict(overrides={"attn_dense_threshold": 4096},
          build_kwargs=dict(logical_overrides={"seq": "model"},
                            microbatch_tokens_per_device=32768))),
    ("granite-34b", "train_4k", "opt4_dense_seqshard_mb4",
     dict(overrides={"attn_dense_threshold": 4096},
          build_kwargs=dict(logical_overrides={"seq": "model"},
                            microbatch_tokens_per_device=16384))),
    # --- paris search: round sizing + query batching ---
    ("paris", "search", "opt1_round16k",
     dict(build_kwargs=dict(round_size=16384))),
    ("paris", "search", "opt2_batch16",
     dict(build_kwargs=dict(batch_queries=16))),
    ("paris", "search", "opt3_batch16_topk",
     dict(build_kwargs=dict(batch_queries=16, select="topk"))),
]


def show(rec: dict, label: str) -> None:
    """Print one dry-run record's roofline terms as a single line."""
    if rec["status"] != "ok":
        print(f"  {label}: ERROR {rec['error'][:160]}")
        return
    r = rec["roofline"]
    print(f"  {label}: compute={r['compute_s']:.3f}s mem={r['memory_s']:.3f}s"
          f" coll={r['collective_s']:.3f}s dom={r['dominant']}"
          f" peak={rec['memory']['peak_estimate_bytes'] / 2**30:.2f}GiB"
          f" ratio={rec.get('model_flops_ratio')}")


def run_variants(outdir: str, only: str | None = None) -> None:
    """Run every (cell, tag) variant, printing baseline-vs-variant terms.

    ``only`` filters on substring match against ``arch/shape/tag``. Each
    cell's baseline is its record in ``outdir`` (``python -m
    repro_torch.launch.dryrun`` writes it). The caller has started the
    dry-run's fake process group (:func:`main` does).
    """
    from repro_torch.launch.dryrun import run_cell

    for arch, shape, tag, kw in VARIANTS:
        if only and only not in f"{arch}/{shape}/{tag}":
            continue
        print(f"== {arch}/{shape} :: {tag}")
        with open(os.path.join(outdir,
                               f"single__{arch}__{shape}.json")) as f:
            base = json.load(f)
        show(base, "baseline")
        rec = run_cell(arch, shape, "single", outdir, tag=tag, **kw)
        show(rec, tag)


def main(argv: Sequence[str] | None = None) -> None:
    """CLI entry: ``python -m repro_torch.launch.hillclimb [filter]`` runs
    the sweep over ``experiments/dryrun_torch/`` (the dry-run's records)
    as rank 0 of the dry-run's fake process group."""
    import sys

    from repro_torch.launch import dryrun, fake_cuda

    args = list(sys.argv[1:] if argv is None else argv)
    fake_cuda.ensure("repro_torch.launch.hillclimb", args)
    outdir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))),
        "experiments", "dryrun_torch")
    with dryrun.fake_world():
        run_variants(outdir, only=args[0] if args else None)


if __name__ == "__main__":
    main()
