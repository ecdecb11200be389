"""The comparison that decides ``correct`` has to fail what is wrong.

On the CPU at a tiny size: the control (the reference in bfloat16, one
precision below the configurations' float32) comes out not correct for
every cell, and a whole run with the timed path broken underneath comes out
not correct for each fault the cell can have: an answer altered where it is
produced, half of a batch left out.
"""

import pytest
import torch

from portbench import control, harness, judge
from repro_torch.core import search

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 777


def plan(cell):
    """The plan of a cell of BENCHMARK.json."""
    return harness.cell_plan(SPEC, cell)


def tiny(cell) -> dict:
    """4096 series, a small pool and sample (the harness tests' sizes)."""
    return {"cfg": {"num_series": 4096},
            "traffic": {"pool": 256, "sample": 16}}


def run(cell) -> bool:
    return harness.run_cell(plan(cell), SEED, 0.2, False, device="cpu",
                            overrides=tiny(cell))["correct"]


@pytest.mark.parametrize("tool", ["control_values", "altered_values"])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_tool_runs_are_not_correct(cell, tool):
    """The bfloat16 control, and the reference with every answer moved to
    the next series, as ``control.py`` runs them on the card."""
    want = plan(cell)
    for part, extra in tiny(cell).items():
        want[part] = {**want[part], **extra}
    for seed in (1, 2, 3):
        values = getattr(control, tool)(want, seed, "cpu")
        correct, checks = judge.verdict(values, want["cfg"]["limits"])
        assert not correct, checks


def _shift(p: torch.Tensor) -> torch.Tensor:
    """Every answer moved to the next series of the collection."""
    return torch.where(p >= 0, (p + 1) % 4096, p)


BATCH_CELLS = [c for c in CELLS
               if plan(c)["traffic"]["loop"] == "closed_batch"]
SINGLE_CELLS = [c for c in CELLS
                if plan(c)["traffic"]["loop"] == "closed_single"]


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch_left_out"])
@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_a_broken_batch_path_is_not_correct(monkeypatch, cell, fault):
    real = search.exact_knn_batch

    def broken(*args, **kwargs):
        d, p, *rest = real(*args, **kwargs)
        if fault == "altered_answer":
            p = _shift(p)
        else:
            half = d.shape[0] // 2
            d, p = d.clone(), p.clone()
            d[half:], p[half:] = float("inf"), -1
        return (d, p, *rest)

    assert run(cell)
    monkeypatch.setattr(search, "exact_knn_batch", broken)
    assert not run(cell)


@pytest.mark.parametrize("cell", SINGLE_CELLS)
def test_a_broken_single_query_is_not_correct(monkeypatch, cell):
    real = search.exact_search_single

    def broken(*args, **kwargs):
        res = real(*args, **kwargs)
        return search.SearchResult(res.dist_sq, _shift(res.position),
                                   res.raw_reads, res.bsf_updates,
                                   res.rounds)

    assert run(cell)
    monkeypatch.setattr(search, "exact_search_single", broken)
    assert not run(cell)
