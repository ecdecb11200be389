"""The candidate selection's plain version against numpy's stable argsort.

``ops.smallest`` gives the k smallest bounds of each row, ascending, ties
toward the lower column: the first k entries of a stable argsort of the
row. The cases cover ties that straddle the k-th place, an all-equal row,
+0.0 bounds, +inf padding rows, k = 1, k = L, L not a multiple of 32, rows
longer than one chunk of the card's kernels (65536 bounds), and Q in
{1, 3, 64}. ``tests/test_torch_cuda.py`` holds the kernel to the plain
version on the same cases. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

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


@pytest.mark.parametrize("name", sorted(CASES))
def test_smallest_equals_stable_argsort_prefix(name):
    lb, k = CASES[name]
    want_cols, want_bounds = stable_prefix(lb, k)
    ops.reset_launch_counts()
    cols, bounds = ops.smallest(torch.from_numpy(lb), k)
    assert cols.dtype == torch.int32 and bounds.dtype == torch.float32
    assert cols.shape == bounds.shape == (lb.shape[0], k)
    np.testing.assert_array_equal(cols.numpy(), want_cols)
    assert np.array_equal(bounds.numpy().view(np.int32),
                          want_bounds.view(np.int32))
    assert ops.launch_counts()["smallest"] == 0  # a CPU tensor: no kernel


def test_smallest_tie_rule_gives_the_fallback_its_bound():
    """The engine's exactness fallback reads the last selected bound
    (``lb_sel[:, -1]``): it is the k-th smallest, whichever tie is cut."""
    lb, k = CASES["ties_straddle_k"]
    _, bounds = ops.smallest(torch.from_numpy(lb), k)
    np.testing.assert_array_equal(bounds[:, -1].numpy(),
                                  np.sort(lb, axis=1)[:, k - 1])
