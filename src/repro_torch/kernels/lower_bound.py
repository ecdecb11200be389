"""Wrapper of the hand-written Hopper lower-bound kernel (``csrc/lower_bound.cu``).

Replaces the TPU kernel ``repro/kernels/lower_bound.py::_lb_kernel_batch``
(``lower_bound_sq_batch_pallas``): (Q, w) f32 query PAA x (N, w) uint8 SAX
-> (Q, N) f32 squared PAA-to-iSAX lower bounds. The TPU kernel wanted the
SAX transposed to (w, N) for its lanes; this one reads the index's (N, w)
rows as they are.

Bound on the H100: the (Q, N) f32 output it writes and the 6w + 1 fp32
operations per (query, row) pair land within 15% of each other at the
paper's shapes (w = 16); ``chip_smoke.py`` computes both. The kernel gives
one thread to each SAX row, which loads its w symbols with vector loads,
keeps the row's region bounds in registers and loops over the queries
staged in shared memory; every store is coalesced. Multiplies and adds are
rounded separately (no fused multiply-add), so the result is bit-identical
to ``ref.lower_bound_sq_batch``: candidate order depends on exact ties.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the caller last set it to 0

SUPPORTED_SEGMENTS = (4, 8, 16, 32)


def lower_bound_sq_batch_cuda(query_paa: torch.Tensor, sax: torch.Tensor,
                              bp_padded: torch.Tensor,
                              series_length: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (Q, N) float32 bounds."""
    global launches
    _build.require(query_paa, "query_paa", torch.float32, 2)
    _build.require(sax, "sax", torch.uint8, 2)
    _build.require(bp_padded, "bp_padded", torch.float32, 1)
    _build.same_device(query_paa, sax, bp_padded)
    n_q, w = query_paa.shape
    n = sax.shape[0]
    if sax.shape[1] != w:
        raise ValueError(f"query PAA has w={w}, SAX rows have {sax.shape[1]}")
    if w not in SUPPORTED_SEGMENTS:
        raise ValueError(f"w={w} not in {SUPPORTED_SEGMENTS}")
    if sax.data_ptr() % min(w, 16):
        raise ValueError("sax rows must be aligned for vector loads")
    if bp_padded.numel() > 257:
        raise ValueError("at most 257 padded breakpoints (uint8 symbols)")
    out = torch.empty((n_q, n), dtype=torch.float32, device=sax.device)
    lib = _build.load()
    err = lib.lower_bound_sq_batch_launch(
        query_paa.data_ptr(), sax.data_ptr(), bp_padded.data_ptr(),
        out.data_ptr(), n_q, n, w, bp_padded.numel(), series_length / w,
        _build.stream_of(sax))
    _build.check(err, "lower_bound_sq_batch")
    launches += 1
    return out
