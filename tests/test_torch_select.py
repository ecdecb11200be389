"""The candidate selection's plain versions against numpy's stable argsort.

``ops.select`` then ``ops.order_range`` over ranks [0, k) give the k
smallest bounds of each row, ascending, ties toward the lower column: the
first k entries of a stable argsort of the row, as the oracle
``ref.smallest`` (an int64-key ``torch.topk``) gives them. The cases cover ties that straddle the k-th place, an all-equal row,
+0.0 bounds, +inf padding rows, k = 1, k = L, L not a multiple of 32, rows
longer than one chunk of the card's kernels (65536 bounds), and Q in
{1, 3, 64}. ``tests/test_torch_cuda.py`` holds the kernels to the plain
versions on the same cases. This file imports no JAX.

The engine's lazy candidate list (``search.CandidateList``: ``ops.select``
then ``ops.order_range`` one prefix at a time) must read, round by round,
exactly what ``ref.smallest``'s sorted list holds: every extent its
schedule produces, ties broken by column, a list length that is not a
multiple of the round size, and the full sort (``sel_len == L``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import search
from repro_torch.kernels import ops, ref

INF = np.float32(np.inf)


def selection_cases() -> dict:
    """name -> ((Q, L) float32 bounds, k): every case of the selection."""
    rng = np.random.RandomState(26)

    def levels(q, n, m):  # bounds on m levels: ties everywhere
        return (rng.randint(0, m, size=(q, n)) * 0.25).astype(np.float32)

    def uniform(q, n):
        return rng.exponential(5.0, size=(q, n)).astype(np.float32)

    zeros = uniform(3, 1000)
    zeros[:, ::3] = 0.0  # +0.0 bounds: a third of each row
    pads = uniform(3, 300)
    pads[:, 240:] = INF  # +inf padding rows, as a packed view gives them
    pads[2] = INF
    long_ties = levels(3, 150_001, 1000)
    return {
        "ties_straddle_k": (levels(3, 1000, 10), 137),
        "all_equal_row": (np.full((3, 77), 2.5, np.float32), 10),
        "zero_bounds": (zeros, 400),
        "inf_padding": (pads, 280),
        "k_is_1": (uniform(64, 1000), 1),
        "k_is_L": (levels(3, 999, 40), 999),
        "q1_odd_length": (uniform(1, 5003), 313),
        "q64": (levels(64, 2049, 300), 100),
        "several_chunks_with_ties": (long_ties, 20_000),
        "full_sort_several_chunks": (levels(2, 70_001, 5000), 70_001),
    }


CASES = selection_cases()


def stable_prefix(lb: np.ndarray, k: int) -> tuple:
    """(columns, bounds) of the first k entries of each row's stable
    argsort."""
    cols = np.argsort(lb, axis=1, kind="stable")[:, :k]
    return cols.astype(np.int32), np.take_along_axis(lb, cols, axis=1)


def smallest(lb: torch.Tensor, k: int) -> tuple:
    """The k smallest of each row, ascending: ``ops.select``, then
    ``ops.order_range`` over the whole list."""
    cols, bounds, _ = ops.select(lb, k)
    return ops.order_range(bounds, cols, 0, k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_smallest_equals_stable_argsort_prefix(name):
    lb, k = CASES[name]
    want_cols, want_bounds = stable_prefix(lb, k)
    ops.reset_launch_counts()
    cols, bounds = smallest(torch.from_numpy(lb), k)
    assert cols.dtype == torch.int32 and bounds.dtype == torch.float32
    assert cols.shape == bounds.shape == (lb.shape[0], k)
    np.testing.assert_array_equal(cols.numpy(), want_cols)
    assert np.array_equal(bounds.numpy().view(np.int32),
                          want_bounds.view(np.int32))
    counts = ops.launch_counts()  # a CPU tensor: no kernel
    assert counts["select"] == counts["order_range"] == 0


def test_smallest_tie_rule_gives_the_fallback_its_bound():
    """The engine's exactness fallback reads the last selected bound
    (``ops.select``'s k-th bound): it is the k-th smallest, whichever tie
    is cut."""
    lb, k = CASES["ties_straddle_k"]
    _, _, kth = ops.select(torch.from_numpy(lb), k)
    np.testing.assert_array_equal(kth.numpy(), np.sort(lb, axis=1)[:, k - 1])


def list_cases() -> dict:
    """name -> ((Q, L) float32 bounds, sel_len, round size)."""
    rng = np.random.RandomState(29)
    ties = (rng.randint(0, 40, size=(3, 5003)) * 0.5).astype(np.float32)
    pads = rng.exponential(3.0, size=(2, 4000)).astype(np.float32)
    pads[:, 3000:] = INF
    return {
        # 312 entries, rounds of 7: extents 14, 56, 224, 312 (the end)
        "ties_ragged_end": (ties, search.select_len(5003, 7), 7),
        # 4000 entries: the first prefix is a 32nd of them (125 -> 126)
        "share_of_the_list": (ties[:2].repeat(3, axis=1), 4000, 7),
        "full_sort": (rng.exponential(2.0, size=(2, 999)).astype(np.float32),
                      999, 10),
        "inf_padding": (pads, 3500, 16),
        "q1_one_prefix": (rng.exponential(1.0, size=(1, 777)).astype(
            np.float32), 100, 64),
    }


def extents(sel_len: int, rs: int) -> list:
    """The ordered prefix lengths the list's schedule passes through when
    the loop runs every round: the first prefix, then four times the
    prefix, never past the list's end."""
    out = [search.CandidateList.first_prefix(sel_len, rs)]
    while out[-1] < sel_len:
        out.append(min(sel_len, search.PREFIX_GROWTH * out[-1]))
    return out


@pytest.mark.parametrize("name", sorted(list_cases()))
def test_candidate_list_reads_the_sorted_prefix(name):
    lb, sel_len, rs = list_cases()[name]
    lb = torch.from_numpy(lb)
    want_cols, want_bounds = ref.smallest(lb, sel_len)
    cands = search.CandidateList(lb, sel_len, rs, "auto")
    assert torch.equal(cands.last.view(torch.int32),
                       want_bounds[:, -1].view(torch.int32))
    seen = [cands.ordered]
    for r in range(-(-sel_len // rs)):
        head = cands.head(r)
        cols, bounds = cands.round(r)
        assert torch.equal(head.view(torch.int32),
                           want_bounds[:, r * rs].view(torch.int32))
        end = min(sel_len, (r + 1) * rs)
        assert torch.equal(cols[:, :end - r * rs], want_cols[:, r * rs:end])
        assert torch.equal(bounds[:, :end - r * rs].view(torch.int32),
                           want_bounds[:, r * rs:end].view(torch.int32))
        assert (cols[:, end - r * rs:] == 0).all()  # padding past the end
        assert torch.isinf(bounds[:, end - r * rs:]).all()
        if cands.ordered != seen[-1]:
            seen.append(cands.ordered)
    assert seen == extents(sel_len, rs)


def test_candidate_list_orders_only_what_the_loop_reaches():
    """A loop that stops after round 2's check has ordered two rounds and
    then one extension (the check reads round 2's head); rounds it never
    checks are never ordered."""
    lb, sel_len, rs = list_cases()["ties_ragged_end"]
    cands = search.CandidateList(torch.from_numpy(lb), sel_len, rs, "auto")
    assert cands.ordered == 2 * rs
    cands.round(0)
    cands.head(1)
    cands.round(1)
    assert cands.ordered == 2 * rs
    cands.head(2)
    assert cands.ordered == 8 * rs


@pytest.mark.parametrize("sel_len,rs,first", [
    (312, 7, 14),  # two rounds: more than a 32nd of the list
    (4000, 7, 126),  # a 32nd (125), rounded up to whole rounds
    (1 << 20, 4096, 1 << 15),  # the batch cells: 8 rounds
    (1_161_216, 4096, 36864),  # the live cell's N_pad / 16: 9 rounds
    (20, 16, 20),  # never past the list's end
])
def test_first_prefix_is_whole_rounds_and_a_share_of_the_list(sel_len, rs,
                                                             first):
    assert search.CandidateList.first_prefix(sel_len, rs) == first


@pytest.mark.parametrize("name", sorted(CASES))
def test_select_and_order_range_give_smallest(name):
    """``ops.select``'s column-order entries and last bound, and
    ``ops.order_range`` over them in three pieces, rebuild
    ``ref.smallest`` bit for bit (the plain versions here; the card's
    kernels in ``test_torch_cuda.py``)."""
    lb, k = CASES[name]
    lb = torch.from_numpy(lb)
    want_cols, want_bounds = ref.smallest(lb, k)
    cols, bounds, kth = ops.select(lb, k)
    assert torch.equal(cols, torch.sort(want_cols, dim=1).values)
    assert torch.equal(bounds.view(torch.int32),
                       lb.gather(1, cols.long()).view(torch.int32))
    assert torch.equal(kth.view(torch.int32),
                       want_bounds[:, -1].view(torch.int32))
    cuts = sorted({0, k // 3, (2 * k) // 3, k})
    got = [ops.order_range(bounds, cols, lo, hi) for lo, hi in
           zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat([c for c, _ in got], 1), want_cols)
    assert torch.equal(torch.cat([b for _, b in got], 1).view(torch.int32),
                       want_bounds.view(torch.int32))
