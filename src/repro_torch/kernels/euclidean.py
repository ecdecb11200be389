"""Wrapper of the hand-written Hopper distance kernel (``csrc/euclidean.cu``).

Replaces the TPU kernel ``repro/kernels/euclidean.py::_euclid_kernel``
(``euclid_sq_pallas``): squared Euclidean distances by the direct
difference sum. On the TPU an XLA gather fetched the candidate rows and the
kernel ran once per query under ``vmap``; here one launch takes (Q, n)
queries, the raw (N, n) rows and (Q, R) int32 positions and returns (Q, R)
distances, with the gather fused in. Positions are clamped to [0, N - 1]
like the reference's ``take(..., mode="clip")``, so ``NO_POS = -1`` reads
row 0. One (R,) position vector shared by every query passes with row
stride 0.

Bound on the H100: memory, the gathered rows (Q*R*n*4 bytes for per-query
positions). The kernel gives each query a block, with the query in shared
memory, and each candidate row a warp whose lanes read it in 16-byte
pieces, several rows in flight per warp. It sums in another order than
``ref.euclid_sq_gather``, so the two agree to float rounding.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the caller last set it to 0

MAX_QUERIES = 65535  # one grid row per query


def euclid_sq_gather_cuda(queries: torch.Tensor, raw: torch.Tensor,
                          positions: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; ``positions`` is (Q, R), or (R,) shared by all."""
    global launches
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
    out = torch.empty((n_q, r), dtype=torch.float32, device=raw.device)
    lib = _build.load()
    err = lib.euclid_sq_gather_launch(
        queries.data_ptr(), raw.data_ptr(), positions.data_ptr(),
        out.data_ptr(), n_q, r, n_rows, n, stride, _build.stream_of(raw))
    _build.check(err, "euclid_sq_gather")
    launches += 1
    return out
