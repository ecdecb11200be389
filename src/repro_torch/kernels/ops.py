"""Dispatch between the hand-written CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``. A tensor on the card (a fake one
too, under the dry-run's ``FakeTensorMode``) goes through the kernel's
operator ``torch.ops.repro_torch.*`` (``kernels/library.py``), whose CUDA
implementation is the ``*_cuda`` wrapper. Every op takes ``impl``:

  * ``"auto"`` — the CUDA kernel for a tensor on the card, the plain
                 PyTorch version for a tensor on the CPU;
  * ``"ref"``  — the plain version wherever the tensor lies (the CPU tests,
                 and ``chip_smoke.py`` comparing a kernel with it on the card);
  * ``"sisd"`` — :func:`lower_bound_sq` only: the paper's Table-1 scalar
                 baseline (``ref.lower_bound_sq_sisd``), on whatever device
                 the tensor lies. Only an explicit request reaches it.

The device of the tensor decides, nothing else: a CUDA tensor launches the
kernel or raises (no build, a refused launch, an unsupported shape), and
there is no ``try`` that gives way to the plain version. A kernel's launch
shape (``block_q``, ``threads``, ``rows``, ``blocks_per_sm``,
``rows_per_warp``) is resolved through ``repro_torch.core.tuning`` (once
per Q/N bucket until the table changes): an explicit kwarg here wins, then
the committed H100 table, then the registry default. On the CPU those knobs
are dead.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import euclidean as _euclid
from repro_torch.kernels import library as _library  # noqa: F401
from repro_torch.kernels import lower_bound as _lb
from repro_torch.kernels import paa_isax as _pi
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import select as _select

_OPS = torch.ops.repro_torch

# name -> (wrapper module, its attribute: the kernel's LaunchCounter)
KERNELS = {
    "paa_isax": (_pi, "launches"),
    "lower_bound_sq_batch": (_lb, "launches"),
    "lower_bound_sq": (_lb, "single_launches"),
    "lower_bound_sq_multi": (_lb, "multi_launches"),
    "euclid_sq": (_euclid, "launches"),
    "euclid_min": (_euclid, "min_launches"),
    "select": (_select, "select_launches"),
    "order_range": (_select, "range_launches"),
    "engine_round": (_euclid, "round_launches"),
}


def _use_kernel(t: torch.Tensor, impl: str) -> bool:
    if impl == "ref":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto', 'ref' or (lower_bound_sq "
                         f"only) 'sisd', got {impl!r}")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def launch_counts() -> dict:
    """Kernel launches per kernel since :func:`reset_launch_counts`."""
    return {name: getattr(mod, attr).value
            for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod, attr in KERNELS.values():
        getattr(mod, attr).reset()


def lower_bound_sq(
    query_paa: torch.Tensor,
    sax: torch.Tensor,
    bp_padded: torch.Tensor,
    series_length: int,
    *,
    impl: str = "auto",
    transposed: bool = False,
    threads=None,
    blocks_per_sm=None,
) -> torch.Tensor:
    """(w,) PAA x (N, w) sax -> (N,) squared lower bounds.

    ``transposed`` is accepted as the reference's ``ops.lower_bound_sq``
    accepts it, with the same (N, w) input: the reference transposes the
    SAX inside, to (w, N), so that candidates fill the TPU's 128-wide lanes.
    On the card one thread reads one (N, w) row either way, so the flag
    changes nothing (and the answer is the same in both packages).
    """
    del transposed  # a TPU layout choice; one layout serves both here
    if impl == "sisd":
        return _ref.lower_bound_sq_sisd(query_paa, sax, bp_padded,
                                        series_length)
    if not _use_kernel(sax, impl):
        return _ref.lower_bound_sq(query_paa, sax, bp_padded, series_length)
    return _OPS.lower_bound_sq(
        query_paa.contiguous(), sax, bp_padded, series_length,
        threads=threads, blocks_per_sm=blocks_per_sm)


def lower_bound_sq_batch(
    query_paa: torch.Tensor,
    sax: torch.Tensor,
    bp_padded: torch.Tensor,
    series_length: int,
    *,
    impl: str = "auto",
    block_q=None,
    threads=None,
    rows=None,
) -> torch.Tensor:
    """(Q, w) PAA batch x (N, w) sax -> (Q, N) squared lower bounds."""
    if not _use_kernel(sax, impl):
        return _ref.lower_bound_sq_batch(
            query_paa, sax, bp_padded, series_length)
    return _OPS.lower_bound_sq_batch(
        query_paa.contiguous(), sax, bp_padded, series_length,
        block_q=block_q, threads=threads, rows=rows)


def lower_bound_sq_multi(
    query_paa: torch.Tensor,
    sax: torch.Tensor,
    bp_padded: torch.Tensor,
    series_length: int,
    block_len: torch.Tensor,
    *,
    impl: str = "auto",
    block_n: int = 128,
    block_q=None,
    threads=None,
    rows=None,
) -> torch.Tensor:
    """(Q, w) PAA x (N_pad, w) PACKED multi-component sax -> (Q, N_pad).

    ``sax`` concatenates every component's leaf-sorted rows, each padded
    to a ``block_n`` multiple (``core.search.pack_components``), and
    ``block_len[j]`` counts the real rows of block ``j``. Every other row
    (component pads, dead tail blocks) comes back +inf, so no selection
    can pick one. ``block_n`` is the layout the buffer was packed with
    (a property of the data, so it is never looked up in the table).
    """
    n = sax.shape[0]
    if n % block_n:
        raise ValueError(f"packed N={n} not a multiple of block_n={block_n}")
    if block_len.shape[0] != n // block_n:
        raise ValueError(
            f"block_len has {block_len.shape[0]} entries for "
            f"{n // block_n} blocks")
    if not _use_kernel(sax, impl):
        lanes = torch.arange(block_n, dtype=torch.int32, device=sax.device)
        valid = (lanes[None, :] < block_len.to(torch.int32)[:, None])
        return _ref.lower_bound_sq_batch_multi(
            query_paa, sax, bp_padded, series_length, valid.reshape(-1))
    return _OPS.lower_bound_sq_multi(
        query_paa.contiguous(), sax, bp_padded, series_length,
        block_len.to(torch.int32).contiguous(), block_n, block_q=block_q,
        threads=threads, rows=rows)


def paa_isax(
    series: torch.Tensor,
    breakpoints: torch.Tensor,
    segments: int,
    *,
    impl: str = "auto",
    normalize: bool = True,
    threads=None,
) -> tuple:
    """(B, n) raw -> ((B, w) uint8 sax, (B, w) f32 paa)."""
    if not _use_kernel(series, impl):
        return _ref.paa_isax(series, segments, breakpoints, normalize)
    return _OPS.paa_isax(series, breakpoints, segments, normalize,
                         threads=threads)


def euclid_sq_gather(
    queries: torch.Tensor,
    raw: torch.Tensor,
    positions: torch.Tensor,
    *,
    impl: str = "auto",
    threads=None,
    rows_per_warp=None,
) -> torch.Tensor:
    """(Q, n) queries x raw rows at positions -> (Q, R) squared distances.

    ``positions`` is (Q, R) per query, or (R,) shared by every query; it is
    clamped to the rows of ``raw`` (``NO_POS`` reads row 0).
    """
    if not _use_kernel(raw, impl):
        if positions.dim() == 1:
            positions = positions[None, :].expand(queries.shape[0], -1)
        return _ref.euclid_sq_gather(queries, raw, positions)
    return _OPS.euclid_sq_gather(
        queries.contiguous(), raw, positions.to(torch.int32).contiguous(),
        threads=threads, rows_per_warp=rows_per_warp)


def euclid_sq(
    query: torch.Tensor,
    data: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """(n,) query x (B, n) data -> (B,) squared distances.

    On the card this is the gather kernel with identity positions.
    """
    if not _use_kernel(data, impl):
        return _ref.euclid_sq(query, data)
    ident = torch.arange(data.shape[0], dtype=torch.int32, device=data.device)
    return _OPS.euclid_sq_gather(
        query.reshape(1, -1).contiguous(), data, ident)[0]


def euclid_min(
    query: torch.Tensor,
    data: torch.Tensor,
    *,
    impl: str = "auto",
) -> tuple:
    """(n,) x (B, n) -> (min squared distance, int32 argmin), first row on ties.

    The brute-force scan: on the card the (B,) distances are never
    written to device memory.
    """
    if not _use_kernel(data, impl):
        return _ref.euclid_min(query, data)
    return _OPS.euclid_min(query.contiguous(), data)


def select(lb: torch.Tensor, k: int, *, impl: str = "auto") -> tuple:
    """(Q, L) bounds -> the k smallest of each row, ties toward the lower
    column (``ref.smallest``'s entries), in column order, unsorted, and
    each row's k-th smallest bound: ((Q, k) int32 columns, (Q, k) float32
    bounds, (Q,) float32). On the card one launch set of the selection
    kernels (``csrc/select.cu``).

    The engine's first selection phase; :func:`order_range` orders what
    the round loop reaches of it.
    """
    if not _use_kernel(lb, impl):
        return _ref.select(lb, k)
    return _OPS.select(lb.contiguous(), k)


def order_range(bounds: torch.Tensor, cols: torch.Tensor, lo: int, hi: int,
                prev_bounds=None, prev_cols=None, *,
                impl: str = "auto") -> tuple:
    """Ranks [lo, hi) of each row of a (Q, L) column-order list
    (:func:`select`'s) in (bound bits, column) order: ((Q, hi - lo) int32
    columns, (Q, hi - lo) float32 bounds), bit for bit ``ref.smallest``'s
    entries lo..hi-1 of the bounds the list came from.

    ``prev_bounds``/``prev_cols`` ((Q,)) are each row's rank lo - 1 entry,
    given exactly when lo > 0: the kernels find the range from them. The
    plain version finds it by rank and does not read them.
    """
    if not _use_kernel(bounds, impl):
        return _ref.order_range(bounds, cols, lo, hi)
    if lo:
        prev_bounds = prev_bounds.contiguous()
        prev_cols = prev_cols.contiguous()
    return _OPS.order_range(bounds.contiguous(), cols.contiguous(), lo, hi,
                            prev_bounds, prev_cols)


def engine_round(cols, bounds, r: int, round_size: int, rows: tuple,
                 queries, top_d, top_p, reads, updates, state, *,
                 tiers: tuple = (None, None, None), out: tuple = (None, None),
                 impl: str = "auto") -> None:
    """Round ``r`` of the batch engine's main loop, in place: the exit test,
    the mask, the distances of the masked-in rows, the k = 1 merge and the
    counters (``ref.engine_round`` says what each argument holds).

    ``rows`` is the view's ``(position table, raw rows)``; ``tiers`` the
    tiered engine's ``(eps_factor_sq, budget_rounds, skip_lb)``; ``out``
    the (Q, round_size) distances and positions a k > 1 round writes for
    the engine's merge. ``state`` is (3Q + 2,) int64, zero but for its last
    word, the exit flag, which the round writes. On the card one launch of
    the round form of the gather kernel, counted in ``engine_round``; on
    the CPU, or with ``impl="ref"``, the plain version, which launches and
    counts nothing.
    """
    pos_table, raw = rows
    if not _use_kernel(raw, impl):
        _ref.engine_round(cols, bounds, r, round_size,
                          *_ref.row_hooks(pos_table, raw), queries, top_d,
                          top_p, reads, updates, state, *tiers, *out)
        return
    _OPS.engine_round(cols, bounds, r, round_size, pos_table, raw,
                      queries.contiguous(), top_d, top_p, reads, updates,
                      state, *tiers, *out)
