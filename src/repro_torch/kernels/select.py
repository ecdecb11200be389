"""Wrappers of the hand-written selection kernels (``csrc/select.cu``).

The k smallest bounds of each row of a (Q, L) float32 tensor, ascending,
ties toward the lower column, bit for bit what ``ref.smallest`` (the
int64-key ``torch.topk``) gives, in two phases that the engine runs apart:
:func:`select_cuda` gives those k pairs in column order, unsorted, and each
row's k-th smallest bound; :func:`order_range_cuda` puts ranks [lo, hi) of
such a list in (bound bits, column) order, so that only the prefix the
round loop reaches is ever sorted. None replaces a TPU kernel: the
reference selects with ``jax.lax.top_k``. The source's note gives the
design: a radix select on the bounds' own 32 bits, one stable compaction in
column order and a stable LSD radix sort of the pairs. They take no launch
knob and read nothing back to the host: every kernel's size follows from
the shapes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# One launch set (every kernel of one call) since the caller last set it
# to 0: select and order_range.
select_launches = _build.LaunchCounter()
range_launches = _build.LaunchCounter()

MAX_ROWS = 65535  # one grid row per bound row


def _check_rows(lb: torch.Tensor, k: int, what: str = "k") -> None:
    n_q, n = lb.shape
    if not 1 <= k <= n:
        raise ValueError(f"{what}={k} outside [1, {n}]")
    if n_q > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {n_q}")
    if n > 2 ** 31 - 1:
        raise ValueError(f"at most 2**31 - 1 columns (int32), got {n}")


def select_cuda(lb: torch.Tensor, k: int) -> tuple:
    """(Q, L) f32 bounds on the card -> the k smallest of each row in column
    order: ((Q, k) int32 columns, (Q, k) f32 bounds, (Q,) f32 k-th
    smallest bound)."""
    _build.require(lb, "lb", torch.float32, 2)
    n_q, n = lb.shape
    k = int(k)
    _check_rows(lb, k)
    cols = torch.empty((n_q, k), dtype=torch.int32, device=lb.device)
    bounds = torch.empty((n_q, k), dtype=torch.float32, device=lb.device)
    kth = torch.empty((n_q,), dtype=torch.float32, device=lb.device)
    if n_q == 0:
        return cols, bounds, kth
    lib = _build.load()
    words = lib.select_scratch_words(n_q, n)
    scratch = torch.empty((words,), dtype=torch.int32, device=lb.device)
    err = lib.select_launch(lb.data_ptr(), cols.data_ptr(), bounds.data_ptr(),
                            kth.data_ptr(), scratch.data_ptr(), words, n_q, n,
                            k, _build.stream_of(lb))
    _build.check(err, "select")
    select_launches.add()
    return cols, bounds, kth


def order_range_cuda(bounds: torch.Tensor, cols: torch.Tensor, lo: int,
                     hi: int, prev_bounds=None, prev_cols=None) -> tuple:
    """Ranks [lo, hi) of each row of a (Q, L) column-order list on the card
    (:func:`select_cuda`'s), in (bound bits, column) order: ((Q, hi - lo)
    int32 columns, (Q, hi - lo) f32 bounds).

    For lo > 0, ``prev_bounds`` and ``prev_cols`` ((Q,) f32 and int32) are
    each row's rank lo - 1 entry, the last of the ordered prefix the caller
    holds: the kernels drop every entry at or below it, and keep no state
    between calls.
    """
    _build.require(bounds, "bounds", torch.float32, 2)
    _build.require(cols, "cols", torch.int32, 2)
    _build.same_device(bounds, cols)
    if cols.shape != bounds.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and bounds "
                         f"{tuple(bounds.shape)} differ")
    n_q, n = bounds.shape
    lo, hi = int(lo), int(hi)
    _check_rows(bounds, hi, "hi")
    if not 0 <= lo < hi:
        raise ValueError(f"lo={lo} outside [0, hi={hi})")
    if (prev_bounds is None) != (lo == 0) or (
            (prev_bounds is None) != (prev_cols is None)):
        raise ValueError("prev_bounds and prev_cols are the rank lo - 1 "
                         "entries: both given exactly when lo > 0")
    if lo:
        _build.require(prev_bounds, "prev_bounds", torch.float32, 1)
        _build.require(prev_cols, "prev_cols", torch.int32, 1)
        _build.same_device(bounds, prev_bounds, prev_cols)
        if prev_bounds.shape[0] != n_q or prev_cols.shape[0] != n_q:
            raise ValueError(f"prev entries must have {n_q} rows")
    m = hi - lo
    out_cols = torch.empty((n_q, m), dtype=torch.int32, device=bounds.device)
    out_bounds = torch.empty((n_q, m), dtype=torch.float32,
                             device=bounds.device)
    if n_q == 0:
        return out_cols, out_bounds
    lib = _build.load()
    words = lib.order_range_scratch_words(n_q, n, m)
    scratch = torch.empty((words,), dtype=torch.int32, device=bounds.device)
    err = lib.order_range_launch(
        bounds.data_ptr(), cols.data_ptr(),
        prev_bounds.data_ptr() if lo else None,
        prev_cols.data_ptr() if lo else None, out_cols.data_ptr(),
        out_bounds.data_ptr(), scratch.data_ptr(), words, n_q, n, hi, m,
        _build.stream_of(bounds))
    _build.check(err, "order_range")
    range_launches.add()
    return out_cols, out_bounds
