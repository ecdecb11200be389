"""Plain PyTorch versions of every hand-written kernel in this package.

Counterpart of ``repro/kernels/ref.py``. Each function is the semantic
ground truth its CUDA kernel is held against (on the card by
``chip_smoke.py`` and the card-marked tests) and the path ``ops.py`` takes
for a tensor that lies on the CPU. Each repeats its kernel's arithmetic in
the same order where the kernel promises bitwise results (``paa_isax``
and the three lower bounds). Every sum over the last axis uses
``isax.sum_last``, the reference's order, so on the CPU these functions
match the JAX package's plain versions bit for bit; the ``euclid_sq``
and ``euclid_min`` kernels sum in another order and are held to them with
a tolerance. :func:`smallest`, a ``torch.topk`` over int64 keys, is the
selection's oracle; :func:`select` and :func:`order_range`, the plain
versions of the selection kernels' two phases, are built on the same keys.
:func:`engine_round` is the batch engine's one plain round: the round
kernel's plain version, and the round of stores whose rows the kernel
cannot read.
"""

from __future__ import annotations

import torch

from repro_torch.core import isax

INF = float("inf")
NO_POS = -1  # the engine's unfilled result slot


def lower_bound_sq(
    query_paa: torch.Tensor,
    sax: torch.Tensor,
    bp_padded: torch.Tensor,
    series_length: int,
) -> torch.Tensor:
    """(w,) query PAA x (N, w) uint8 sax -> (N,) squared lower bounds."""
    w = sax.shape[-1]
    idx = sax.to(torch.int64)
    bl = bp_padded[idx]
    bu = bp_padded[idx + 1]
    q = query_paa[None, :].to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=sax.device)
    d = torch.where(q > bu, q - bu, torch.where(q < bl, bl - q, zero))
    return (series_length / w) * isax.sum_last(d * d)


def lower_bound_sq_sisd(
    query_paa: torch.Tensor,
    sax: torch.Tensor,
    bp_padded: torch.Tensor,
    series_length: int,
) -> torch.Tensor:
    """Scalar-at-a-time ("SISD") lower bound: the paper's Table-1 baseline.

    One candidate at a time, one segment at a time, with branching control
    flow per element, in float32 on the tensors' device: deliberately the
    unvectorized formulation the paper compares its SIMD kernel against
    (``repro/kernels/ref.py::lower_bound_sq_sisd``). Each candidate's sum
    runs over the segments in order from 0, ``acc + d * d``, then the
    scale, so its bits are :func:`lower_bound_sq_batch`'s. Slow by design:
    only ``ops.lower_bound_sq(impl="sisd")`` reaches it.
    """
    n_cand, w = sax.shape
    scale = series_length / w
    out = torch.empty((n_cand,), dtype=torch.float32, device=sax.device)
    zero = torch.zeros((), dtype=torch.float32, device=sax.device)
    q_all = query_paa.to(torch.float32)
    for i in range(n_cand):
        acc = zero
        for j in range(w):
            s = int(sax[i, j])
            bl, bu, q = bp_padded[s], bp_padded[s + 1], q_all[j]
            if q > bu:
                d = q - bu
            elif q < bl:
                d = bl - q
            else:
                d = zero
            acc = acc + d * d
        out[i] = scale * acc
    return out


def lower_bound_sq_batch(
    query_paa: torch.Tensor,
    sax: torch.Tensor,
    bp_padded: torch.Tensor,
    series_length: int,
) -> torch.Tensor:
    """(Q, w) query PAA batch x (N, w) uint8 sax -> (Q, N) lower bounds.

    Accumulates segment by segment over (Q, N) planes, as the reference
    does: ``acc + d * d`` rounds the product and the sum separately, which
    is the order the kernel keeps (``__fmul_rn``/``__fadd_rn``).
    """
    n_q, w = query_paa.shape
    idx = sax.to(torch.int64)
    bl = bp_padded[idx]  # (N, w)
    bu = bp_padded[idx + 1]
    q = query_paa.to(torch.float32)
    acc = torch.zeros((n_q, sax.shape[0]), dtype=torch.float32,
                      device=sax.device)
    for j in range(w):
        qj = q[:, j][:, None]  # (Q, 1)
        d = torch.clamp_min(
            torch.maximum(qj - bu[:, j][None, :], bl[:, j][None, :] - qj), 0.0)
        acc = acc + d * d
    return (series_length / w) * acc


def lower_bound_sq_batch_multi(
    query_paa: torch.Tensor,
    sax: torch.Tensor,
    bp_padded: torch.Tensor,
    series_length: int,
    valid: torch.Tensor,
) -> torch.Tensor:
    """(Q, w) PAA batch x (N_pad, w) packed sax -> (Q, N_pad) lower bounds.

    The packed multi-component buffer (``core.search.pack_components``);
    ``valid`` is the (N_pad,) bool row mask. Pad rows come back +inf, so
    no selection can pick them.
    """
    lb = lower_bound_sq_batch(query_paa, sax, bp_padded, series_length)
    return torch.where(valid[None, :], lb, float("inf"))


def paa_isax(
    series: torch.Tensor,
    segments: int,
    breakpoints: torch.Tensor,
    normalize: bool = True,
) -> tuple:
    """(B, n) raw series -> ((B, w) uint8 symbols, (B, w) f32 PAA).

    ``normalize=True`` z-normalizes as the TPU kernel does
    (``(x - mean) * rsqrt(var + 1e-16)``), which is not ``isax.znorm``;
    ``build_index`` z-norms with ``isax.znorm`` and passes ``False``.
    """
    x = series.to(torch.float32)
    if normalize:
        n = x.shape[-1]
        x = x - (isax.sum_last(x) / n)[:, None]
        x = x * torch.rsqrt(isax.sum_last(x * x) / n + 1e-16)[:, None]
    p = isax.paa(x, segments)
    sym = torch.searchsorted(breakpoints, p.contiguous(), side="left")
    return sym.to(torch.uint8), p


def euclid_sq(query: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(n,) query x (B, n) data -> (B,) squared Euclidean distances."""
    d = data.to(torch.float32) - query[None, :].to(torch.float32)
    return isax.sum_last(d * d)


def euclid_sq_gather(
    queries: torch.Tensor, raw: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """(Q, n) queries x raw (N, n) rows at (Q, R) positions -> (Q, R).

    The fused-gather form the RDC rounds call. Positions are clamped to
    ``[0, N - 1]``, as the reference's ``take(..., mode="clip")``: a
    ``NO_POS = -1`` slot reads row 0, never the last row.
    """
    pos = positions.to(torch.int64).clamp(0, raw.shape[0] - 1)
    d = raw[pos] - queries[:, None, :]  # (Q, R, n)
    return isax.sum_last(d * d)


def euclid_min(query: torch.Tensor, data: torch.Tensor) -> tuple:
    """(n,) query x (B, n) data -> (min squared distance, int32 argmin).

    The first index wins ties, as ``jnp.argmin`` (and ``torch.argmin``)
    does.
    """
    d = euclid_sq(query, data)
    i = torch.argmin(d)
    return d[i], i.to(torch.int32)


def _keys(bounds: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys ``(bits << 32) | column``: unique per row, ordered as
    (bound, column) for non-negative bounds."""
    key = bounds.contiguous().view(torch.int32).to(torch.int64)
    key <<= 32
    key |= cols.to(torch.int64)
    return key


def smallest(lb: torch.Tensor, k: int) -> tuple:
    """The k smallest bounds per row, ascending, ties toward the lower column.

    ``lax.top_k`` in the reference breaks ties toward the lower index;
    ``torch.topk`` promises no tie order. A non-negative float's bits are
    monotone as an integer, so the int64 key ``(bits << 32) | column`` is
    unique per row and orders exactly as (bound, column). Returns
    ((Q, k) int32 columns, (Q, k) float32 bounds).
    """
    key = _keys(lb, torch.arange(lb.shape[1], device=lb.device))
    vals = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    del key
    cols = (vals & 0xFFFFFFFF).to(torch.int32)
    bounds = (vals >> 32).to(torch.int32).view(torch.float32)
    return cols, bounds


def select(lb: torch.Tensor, k: int) -> tuple:
    """:func:`smallest`'s k entries of each row in column order, and each
    row's k-th smallest bound: ((Q, k) int32 columns, (Q, k) float32
    bounds, (Q,) float32)."""
    cols, bounds = smallest(lb, k)
    kth = bounds[:, -1].clone()
    cols = torch.sort(cols, dim=1).values
    return cols, lb.gather(1, cols.to(torch.int64)), kth


def order_range(bounds: torch.Tensor, cols: torch.Tensor, lo: int,
                hi: int) -> tuple:
    """Ranks [lo, hi) of each row of a (Q, L) list of (bound, column)
    entries in (bound bits, column) order: ((Q, hi - lo) int32 columns,
    (Q, hi - lo) float32 bounds). The columns of a row are distinct."""
    vals = torch.topk(_keys(bounds, cols), hi, dim=1, largest=False,
                      sorted=True).values[:, lo:]
    return ((vals & 0xFFFFFFFF).to(torch.int32),
            (vals >> 32).to(torch.int32).view(torch.float32))


def _padded(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    short = width - x.shape[1]
    if short <= 0:
        return x
    return torch.cat([x, x.new_full((x.shape[0], short), fill)], dim=1)


def row_hooks(pos_table: torch.Tensor, raw: torch.Tensor) -> tuple:
    """The ``positions`` and ``distances`` of :func:`engine_round` over a
    position table and raw rows, as the round kernel reads them: a lookup
    in the table, and :func:`euclid_sq_gather` (clipped: ``NO_POS`` reads
    row 0)."""
    return (lambda cols: pos_table[cols.to(torch.int64)],
            lambda queries, pos, mask: euclid_sq_gather(queries, raw, pos))


def exit_test(head, kth, r: int, eps_factor_sq=None,
              budget_rounds=None) -> torch.Tensor:
    """The round's exit test, a 0-d bool on the device: does any query's
    head bound (tiered: times ``eps_factor_sq``, within ``budget_rounds``)
    beat its k-th best ``kth``?"""
    if eps_factor_sq is None:
        return (head < kth).any()
    return ((r < budget_rounds) & (head * eps_factor_sq < kth)).any()


def engine_round(cols, bounds, r: int, round_size: int, positions,
                 distances, queries, top_d, top_p, reads, updates, state,
                 eps_factor_sq=None, budget_rounds=None, skip_lb=None,
                 out_d=None, out_p=None, head=None) -> None:
    """Round ``r`` of the batch engine's loop, in place: the one plain
    round, which the round kernel computes bit for bit and the engine runs
    over stores whose rows it cannot give the kernel.

    ``cols``/``bounds``: round r's (Q, W) columns and bounds, W <=
    ``round_size`` (the rest padded with column 0 and +inf).
    ``positions(cols)`` gives the (Q, round_size) positions of the columns
    and ``distances(queries, positions, mask)`` their (Q, round_size)
    squared distances, of which only the masked-in ones are read
    (:func:`row_hooks` for a position table and raw rows).

    The exit test (:func:`exit_test`) reads the k-th bests as they stand:
    a query passes where its ``head`` (default ``bounds[:, 0]``; tiered:
    times ``eps_factor_sq``, within ``budget_rounds``) beats its k-th best. ``state[-1]`` gets
    whether any query passes; where none does, nothing else changes. Else
    the masked-in candidates (bound < k-th best; tiered, the same test) are
    distanced; ``reads`` gets each query's masked count, ``updates`` 1
    where the round's smallest distance beats the k-th best, ``skip_lb``
    the smallest bound the tier skipped. k = 1 merges the smallest (the
    first column on ties) into ``top_d``/``top_p`` on strict improvement;
    k > 1 writes the masked (Q, round_size) distances and positions (+inf
    and ``NO_POS`` outside the mask) to ``out_d``/``out_p`` for the
    engine's merge. The other words of ``state`` are the kernel's and stay
    0. Nothing is read back to the host.
    """
    tiered = eps_factor_sq is not None
    kth = top_d[:, -1].clone()
    go = exit_test(bounds[:, 0] if head is None else head, kth, r,
                   eps_factor_sq, budget_rounds)
    state[-1] = go
    lbs = _padded(bounds, round_size, INF)
    below = (lbs < kth[:, None]) & go
    if tiered:
        mask = ((lbs * eps_factor_sq[:, None] < kth[:, None])
                & (r < budget_rounds)[:, None] & go)
        skip_lb.copy_(torch.minimum(
            skip_lb, torch.where(below & ~mask, lbs, INF).amin(dim=1)))
    else:
        mask = below
    cand_pos = positions(_padded(cols, round_size, 0))
    d = torch.where(mask, distances(queries, cand_pos, mask), INF)
    reads += mask.sum(dim=1, dtype=torch.int32)
    updates += (d.amin(dim=1) < kth).to(torch.int32)
    if out_d is None:  # k = 1: argmin + strict improvement
        j = torch.argmin(d, dim=1, keepdim=True)
        dj = d.gather(1, j)
        better = dj < top_d
        top_p.copy_(torch.where(better, cand_pos.gather(1, j), top_p))
        top_d.copy_(torch.where(better, dj, top_d))
    else:  # a failed exit test leaves them as they are
        out_d.copy_(torch.where(go, d, out_d))
        out_p.copy_(torch.where(go, torch.where(mask, cand_pos, NO_POS),
                                out_p))
