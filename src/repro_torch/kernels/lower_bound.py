"""Wrappers of the hand-written Hopper lower-bound kernels (``csrc/lower_bound.cu``).

Three entries, each with its wrapper and its own launch count; the two
batch entries share one templated CUDA kernel, the single query has its
own:

  * :func:`lower_bound_sq_batch_cuda` replaces the TPU kernel
    ``repro/kernels/lower_bound.py::_lb_kernel_batch``
    (``lower_bound_sq_batch_pallas``): (Q, w) f32 query PAA x (N, w) uint8
    SAX -> (Q, N) f32 squared PAA-to-iSAX lower bounds;
  * :func:`lower_bound_sq_cuda` replaces ``_lb_kernel_rows`` and
    ``_lb_kernel_cols`` (``lower_bound_sq_pallas``): one (w,) query;
  * :func:`lower_bound_sq_multi_cuda` replaces ``_lb_kernel_batch_masked``
    (``lower_bound_sq_multi_pallas``): the batch form over a packed
    multi-component buffer, +inf on every row outside ``block_len``.

The TPU kernels wanted the SAX transposed to (w, N) for their lanes; these
read the index's (N, w) rows as they are.

Bound on the H100: for the batch forms, the (Q, N) f32 output they write and
the 6w + 1 fp32 operations per (query, row) pair land within 15% of each
other at the paper's shapes (w = 16); the single-query form is bound by
the bytes it reads and writes. ``chip_smoke.py`` computes both. None of
the operations can be fused (multiplies and adds are rounded separately,
so every result is bit-identical to its plain version in ``ref.py``:
candidate order depends on exact ties), so the batch forms are bound in
practice by the rate at which the card issues instructions. Their design
issues 5 per (query, row, segment): two subtractions, one Hopper DPX
integer max-with-relu on the float bits for max(q - hi, lo - q, 0), the
square and the sum. Each thread keeps the region bounds of 4 SAX rows (2
at w = 32) in registers and loops over the queries staged in shared
memory, so each query's loads and loop overhead are shared by its rows;
every store is coalesced.

Launch shapes: each wrapper resolves its kernel's shape at each call
through ``repro_torch.core.tuning`` (``lb_batch``: ``block_q``, ``threads``
and ``rows``; ``lb_multi``: the same; ``lb_single``: ``threads`` and
``blocks_per_sm``): an explicit kwarg wins, then the committed H100 table
for the call's (Q, N) bucket, then the defaults written above. A shape the
source does not instantiate raises before anything launches.

The single-query form is bound by bytes (16 B read and 4 B written a row).
In the batch geometry it reached 43% of that bound: each block of 256 rows
paid three dependent memory latencies and three barriers (the breakpoint
table, the query, then its rows), and its 32 lookups a row went to one
shared table, where lanes whose symbols fall on one bank wait for each
other. Its kernel is a persistent grid instead: as many 512-thread blocks
as the card holds at once load the table and the query once and walk the
rows with a grid-stride loop, each thread loading its next row before it
computes the current one. The table is replicated once per lane (32.9 KB),
so every lookup of a warp is one conflict-free shared-memory wavefront,
whatever the symbols. The arithmetic is the batch forms', bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core import tuning
from repro_torch.kernels import _build

# Kernel launches since the caller last set them to 0, one count per entry.
launches = _build.LaunchCounter()  # lower_bound_sq_batch
single_launches = _build.LaunchCounter()  # lower_bound_sq
multi_launches = _build.LaunchCounter()  # lower_bound_sq_multi

SUPPORTED_SEGMENTS = (4, 8, 16, 32)


def _check_sax(sax: torch.Tensor, w: int, bp_padded: torch.Tensor) -> None:
    if sax.shape[1] != w:
        raise ValueError(f"query PAA has w={w}, SAX rows have {sax.shape[1]}")
    if w not in SUPPORTED_SEGMENTS:
        raise ValueError(f"w={w} not in {SUPPORTED_SEGMENTS}")
    if sax.data_ptr() % min(w, 16):
        raise ValueError("sax rows must be aligned for vector loads")
    if bp_padded.numel() > 257:
        raise ValueError("at most 257 padded breakpoints (uint8 symbols)")


def lower_bound_sq_batch_cuda(query_paa: torch.Tensor, sax: torch.Tensor,
                              bp_padded: torch.Tensor, series_length: int, *,
                              block_q=None, threads=None,
                              rows=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (Q, N) float32 bounds."""
    _build.require(query_paa, "query_paa", torch.float32, 2)
    _build.require(sax, "sax", torch.uint8, 2)
    _build.require(bp_padded, "bp_padded", torch.float32, 1)
    _build.same_device(query_paa, sax, bp_padded)
    n_q, w = query_paa.shape
    _check_sax(sax, w, bp_padded)
    n = sax.shape[0]
    shape = tuning.launch_shape("lb_batch", sax.device, q=n_q, n=n,
                                block_q=block_q, threads=threads, rows=rows)
    out = torch.empty((n_q, n), dtype=torch.float32, device=sax.device)
    lib = _build.load()
    err = lib.lower_bound_sq_batch_launch(
        query_paa.data_ptr(), sax.data_ptr(), bp_padded.data_ptr(),
        out.data_ptr(), n_q, n, w, bp_padded.numel(), series_length / w,
        shape["block_q"], shape["threads"], shape["rows"],
        _build.stream_of(sax))
    _build.check(err, "lower_bound_sq_batch")
    launches.add()
    return out


def lower_bound_sq_cuda(query_paa: torch.Tensor, sax: torch.Tensor,
                        bp_padded: torch.Tensor, series_length: int, *,
                        threads=None, blocks_per_sm=None) -> torch.Tensor:
    """One (w,) query against (N, w) SAX rows; returns (N,) float32 bounds."""
    _build.require(query_paa, "query_paa", torch.float32, 1)
    _build.require(sax, "sax", torch.uint8, 2)
    _build.require(bp_padded, "bp_padded", torch.float32, 1)
    _build.same_device(query_paa, sax, bp_padded)
    w = query_paa.shape[0]
    _check_sax(sax, w, bp_padded)
    n = sax.shape[0]
    shape = tuning.launch_shape("lb_single", sax.device, q=1, n=n,
                                threads=threads, blocks_per_sm=blocks_per_sm)
    out = torch.empty((n,), dtype=torch.float32, device=sax.device)
    lib = _build.load()
    err = lib.lower_bound_sq_launch(
        query_paa.data_ptr(), sax.data_ptr(), bp_padded.data_ptr(),
        out.data_ptr(), n, w, bp_padded.numel(), series_length / w,
        shape["threads"], shape["blocks_per_sm"], _build.stream_of(sax))
    _build.check(err, "lower_bound_sq")
    single_launches.add()
    return out


def lower_bound_sq_multi_cuda(query_paa: torch.Tensor, sax: torch.Tensor,
                              bp_padded: torch.Tensor, series_length: int,
                              block_len: torch.Tensor, block_n: int, *,
                              block_q=None, threads=None,
                              rows=None) -> torch.Tensor:
    """(Q, w) PAA x (N_pad, w) packed SAX -> (Q, N_pad), +inf off the blocks.

    Row ``r`` is real iff ``r % block_n < block_len[r // block_n]``;
    ``block_n`` is the buffer's layout, never resolved from the table.
    """
    _build.require(query_paa, "query_paa", torch.float32, 2)
    _build.require(sax, "sax", torch.uint8, 2)
    _build.require(bp_padded, "bp_padded", torch.float32, 1)
    _build.require(block_len, "block_len", torch.int32, 1)
    _build.same_device(query_paa, sax, bp_padded, block_len)
    n_q, w = query_paa.shape
    _check_sax(sax, w, bp_padded)
    n = sax.shape[0]
    if block_n < 1 or n % block_n:
        raise ValueError(f"packed N={n} not a multiple of block_n={block_n}")
    if block_len.shape[0] != n // block_n:
        raise ValueError(f"block_len has {block_len.shape[0]} entries for "
                         f"{n // block_n} blocks")
    shape = tuning.launch_shape("lb_multi", sax.device, q=n_q, n=n,
                                block_q=block_q, threads=threads, rows=rows,
                                block_n=block_n)
    out = torch.empty((n_q, n), dtype=torch.float32, device=sax.device)
    lib = _build.load()
    err = lib.lower_bound_sq_multi_launch(
        query_paa.data_ptr(), sax.data_ptr(), bp_padded.data_ptr(),
        block_len.data_ptr(), out.data_ptr(), n_q, n, w, bp_padded.numel(),
        block_n, series_length / w, shape["block_q"], shape["threads"],
        shape["rows"], _build.stream_of(sax))
    _build.check(err, "lower_bound_sq_multi")
    multi_launches.add()
    return out
