"""The lattice search the kernel autotuner runs (``repro_torch.core.tuning``).

Counterpart of ``repro/launch/hillclimb.py``'s search loop, copied as it
is, so the two tuners take the same steps on the same cost surface:

  * :func:`snap_to_lattice` — the nearest lattice point to a value;
  * :func:`coordinate_descent` — greedy search over a product lattice: one
    axis at a time, step to a neighbour only when it wins by more than
    ``min_gain`` (the noise floor), repeat until no axis improves.

The reference module also holds the LM dry-run variant sweep
(``run_variants``/``VARIANTS``), which belongs to the LM side-stack and has
no counterpart here yet. Importing this module imports nothing else.
"""

from __future__ import annotations

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
