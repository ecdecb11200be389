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
"""

from __future__ import annotations

import torch

from repro_torch.core import tuning
from repro_torch.kernels import _build

# Kernel launches since the caller last set them to 0, one count per entry.
launches = _build.LaunchCounter()  # euclid_sq (the gather form)
min_launches = _build.LaunchCounter()  # euclid_min

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
