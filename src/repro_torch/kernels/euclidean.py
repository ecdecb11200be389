"""Wrappers of the hand-written Hopper distance kernels (``csrc/euclidean.cu``).

:func:`euclid_sq_gather_cuda` replaces the TPU kernel
``repro/kernels/euclidean.py::_euclid_kernel`` (``euclid_sq_pallas``):
squared Euclidean distances by the direct difference sum. On the TPU an XLA gather fetched the candidate rows and the
kernel ran once per query under ``vmap``; here one launch takes (Q, n)
queries, the raw (N, n) rows and (Q, R) int32 positions and returns (Q, R)
distances, with the gather fused in. Positions are clamped to [0, N - 1]
like the reference's ``take(..., mode="clip")``, so ``NO_POS = -1`` reads
row 0. One (R,) position vector shared by every query passes with row
stride 0.

Bound on the H100: memory, the gathered rows (Q*R*n*4 bytes for per-query
positions). The kernel gives each query a block, with the query in shared
memory, and each candidate row a warp whose lanes read it in 16-byte
pieces, several rows in flight per warp. The block's ``threads`` and the
``rows_per_warp`` resolve at each call through ``repro_torch.core.tuning``
(``euclid``: explicit kwarg, the committed H100 table for the (Q, R)
bucket, then 256 and 4); each admitted pair gives the same bits. It sums in another order than
``ref.euclid_sq_gather``, so the two agree to float rounding.

:func:`euclid_min_cuda` replaces ``_euclid_min_kernel``
(``euclid_min_pallas``), the brute-force scan: the (min, argmin) of one
query's distances to every row, with the first row winning ties, and the
(B,) distance vector never written to device memory. Blocks reduce their
rows to one 64-bit key, (distance bits << 32) | row, and meet in one
``atomicMin``; distances are non-negative, so the key orders as
(distance, row). Bound: memory, the B x n rows read once.

:func:`engine_round_cuda` is one round of the batch engine's main loop
(``core/search.py``, ``_engine_core``) as one launch of the round form of
the gather kernel, in place of about twenty PyTorch launches: the exit
test, the mask, the position lookup, the distances of the masked-in rows
only (through the gather form's per-row warp sum, so each distance has its
bits), the k = 1 merge (the smallest (distance bits << 32) | column key, as
``euclid_min`` orders its rows) and the ``reads`` and ``updates`` counters.
Its plain version is ``ref.engine_round``; the source's note gives the
design. Bound: memory, the masked-in rows plus the round's columns and
bounds.
"""

from __future__ import annotations

import torch

from repro_torch.core import tuning
from repro_torch.kernels import _build

# Kernel launches since the caller last set them to 0, one count per entry.
launches = _build.LaunchCounter()  # euclid_sq (the gather form)
min_launches = _build.LaunchCounter()  # euclid_min
round_launches = _build.LaunchCounter()  # engine_round

MAX_QUERIES = 65535  # one grid row per query


def euclid_sq_gather_cuda(queries: torch.Tensor, raw: torch.Tensor,
                          positions: torch.Tensor, *, threads=None,
                          rows_per_warp=None) -> torch.Tensor:
    """Launch the kernel; ``positions`` is (Q, R), or (R,) shared by all."""
    _build.require(queries, "queries", torch.float32, 2)
    _build.require(raw, "raw", torch.float32, 2)
    if positions.dim() not in (1, 2):
        raise ValueError(f"positions: expected 1 or 2 dims, got "
                         f"{tuple(positions.shape)}")
    _build.require(positions, "positions", torch.int32, positions.dim())
    _build.same_device(queries, raw, positions)
    n_q, n = queries.shape
    n_rows = raw.shape[0]
    if raw.shape[1] != n:
        raise ValueError(f"queries have n={n}, raw rows have {raw.shape[1]}")
    if n_rows == 0:
        raise ValueError("raw has no rows to gather")
    if n_q > MAX_QUERIES:
        raise ValueError(f"at most {MAX_QUERIES} queries per launch")
    if n * 4 > 48 * 1024:
        raise ValueError(f"series length {n} exceeds the shared-memory stage")
    if positions.dim() == 2:
        if positions.shape[0] != n_q:
            raise ValueError(
                f"positions has {positions.shape[0]} rows for {n_q} queries")
        r, stride = positions.shape[1], positions.shape[1]
    else:
        r, stride = positions.shape[0], 0
    shape = tuning.launch_shape("euclid", raw.device, q=n_q, n=r,
                                threads=threads, rows_per_warp=rows_per_warp)
    out = torch.empty((n_q, r), dtype=torch.float32, device=raw.device)
    lib = _build.load()
    err = lib.euclid_sq_gather_launch(
        queries.data_ptr(), raw.data_ptr(), positions.data_ptr(),
        out.data_ptr(), n_q, r, n_rows, n, stride, shape["threads"],
        shape["rows_per_warp"], _build.stream_of(raw))
    _build.check(err, "euclid_sq_gather")
    launches.add()
    return out


def euclid_min_cuda(query: torch.Tensor, data: torch.Tensor) -> tuple:
    """(n,) query x (B, n) rows -> (0-d f32 min distance, 0-d int32 row)."""
    _build.require(query, "query", torch.float32, 1)
    _build.require(data, "data", torch.float32, 2)
    _build.same_device(query, data)
    b, n = data.shape
    if query.shape[0] != n:
        raise ValueError(f"query has n={query.shape[0]}, rows have {n}")
    if b == 0:
        raise ValueError("data has no rows to scan")
    if b > 2 ** 31 - 1:
        raise ValueError(f"at most 2**31 - 1 rows (int32 positions), got {b}")
    if n * 4 > 48 * 1024:
        raise ValueError(f"series length {n} exceeds the shared-memory stage")
    best = torch.full((1,), -1, dtype=torch.int64, device=data.device)
    lib = _build.load()
    err = lib.euclid_min_launch(query.data_ptr(), data.data_ptr(),
                                best.data_ptr(), b, n, _build.stream_of(data))
    _build.check(err, "euclid_min")
    min_launches.add()
    key = best[0]
    dist = (key >> 32).to(torch.int32).view(torch.float32)
    return dist, (key & 0xFFFFFFFF).to(torch.int32)


def _require_view(t: torch.Tensor, name: str, dtype) -> None:
    """A (Q, W) CUDA tensor of ``dtype`` whose rows are contiguous."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name}: expected a 2-d {dtype} tensor with "
                         f"contiguous rows, got {t.dtype} {tuple(t.shape)} "
                         f"strides {t.stride()}")


def engine_round_cuda(cols: torch.Tensor, bounds: torch.Tensor, r: int,
                      round_size: int, pos_table: torch.Tensor,
                      raw: torch.Tensor, queries: torch.Tensor,
                      top_d: torch.Tensor, top_p: torch.Tensor,
                      reads: torch.Tensor, updates: torch.Tensor,
                      state: torch.Tensor, eps_factor_sq=None,
                      budget_rounds=None, skip_lb=None, out_d=None,
                      out_p=None) -> None:
    """Launch round ``r`` of the engine's loop; see ``ops.engine_round``.

    ``cols``/``bounds`` are round r's (Q, W) views of the candidate list
    (W <= ``round_size``, rows contiguous, one row stride); the result
    lists and counters are updated in place and ``state[-1]`` gets the
    exit flag.
    """
    _require_view(cols, "cols", torch.int32)
    _require_view(bounds, "bounds", torch.float32)
    _build.require(pos_table, "pos_table", torch.int32, 1)
    _build.require(raw, "raw", torch.float32, 2)
    _build.require(queries, "queries", torch.float32, 2)
    _require_view(top_d, "top_d", torch.float32)
    _require_view(top_p, "top_p", torch.int32)
    for t, name in ((reads, "reads"), (updates, "updates")):
        _build.require(t, name, torch.int32, 1)
    _build.require(state, "state", torch.int64, 1)
    n_q, n = queries.shape
    k = top_d.shape[1]
    width = cols.shape[1]
    tiers = (eps_factor_sq, budget_rounds, skip_lb)
    if cols.shape != bounds.shape or cols.stride() != bounds.stride():
        raise ValueError("cols and bounds must be views of one layout")
    if cols.shape[0] != n_q or top_d.shape != top_p.shape or (
            top_d.shape[0] != n_q) or reads.shape[0] != n_q or (
            updates.shape[0] != n_q) or state.shape[0] != 3 * n_q + 2:
        raise ValueError(f"every per-query tensor needs {n_q} rows and "
                         f"state 3Q + 2 words")
    if not 1 <= width <= round_size:
        raise ValueError(f"a round of {width} columns for round_size "
                         f"{round_size}")
    if raw.shape[1] != n or raw.shape[0] == 0:
        raise ValueError(f"queries have n={n}, raw is {tuple(raw.shape)}")
    if n_q > MAX_QUERIES:
        raise ValueError(f"at most {MAX_QUERIES} queries per launch")
    if n * 4 > 48 * 1024:
        raise ValueError(f"series length {n} exceeds the shared-memory stage")
    if any(t is None for t in tiers) != all(t is None for t in tiers):
        raise ValueError("eps_factor_sq, budget_rounds and skip_lb come "
                         "together")
    if tiers[0] is not None:
        for t, name, dt in zip(tiers, ("eps_factor_sq", "budget_rounds",
                                       "skip_lb"),
                               (torch.float32, torch.int32, torch.float32)):
            _build.require(t, name, dt, 1)
    if (k > 1) != (out_d is not None) or (out_d is None) != (out_p is None):
        raise ValueError("out_d and out_p are given exactly when k > 1")
    if out_d is not None:
        _build.require(out_d, "out_d", torch.float32, 2)
        _build.require(out_p, "out_p", torch.int32, 2)
        if out_d.shape != (n_q, round_size) or out_p.shape != out_d.shape:
            raise ValueError(f"out_d and out_p must be ({n_q}, "
                             f"{round_size})")
    _build.same_device(cols, bounds, pos_table, raw, queries, top_d, top_p,
                       reads, updates, state,
                       *(t for t in (*tiers, out_d, out_p) if t is not None))

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load()
    err = lib.engine_round_launch(
        cols.data_ptr(), bounds.data_ptr(), cols.stride(0), width,
        round_size, r, pos_table.data_ptr(), raw.data_ptr(), raw.shape[0], n,
        queries.data_ptr(), top_d.data_ptr(), top_d.stride(0),
        top_p.data_ptr(), top_p.stride(0), k, reads.data_ptr(),
        updates.data_ptr(), *map(ptr, tiers), ptr(out_d), ptr(out_p),
        state.data_ptr(), n_q, _build.stream_of(raw))
    _build.check(err, "engine_round")
    round_launches.add()
