"""Wrapper of the hand-written Hopper ``paa_isax`` kernel (``csrc/paa_isax.cu``).

Replaces the TPU kernel ``repro/kernels/paa_isax.py::_paa_isax_kernel``
(``paa_isax_pallas``): (B, n) f32 series -> ((B, w) uint8 symbols, (B, w)
f32 PAA), with an optional z-norm.

Bound on the H100: memory. It reads each series once (B*n*4 bytes) and
does one add per value read. The kernel gives one thread to each (series,
segment) pair: the thread sums its segment in the plain version's order
(``isax.sum_last``), so symbols and PAA are bit-identical to
``ref.paa_isax(normalize=False)``, and finds the symbol by binary search
over the breakpoints held in shared memory. The block's ``threads``
resolve at each call through ``repro_torch.core.tuning`` (``paa_isax``:
explicit kwarg, the committed H100 table for the series count's bucket,
then 256); a thread's sums do not depend on them.
"""

from __future__ import annotations

import torch

from repro_torch.core import tuning
from repro_torch.kernels import _build

launches = _build.LaunchCounter()  # launches since the last reset


def paa_isax_cuda(series: torch.Tensor, breakpoints: torch.Tensor,
                  segments: int, normalize: bool = True, *,
                  threads=None) -> tuple:
    """Launch the kernel on CUDA tensors; returns (sax uint8, paa f32)."""
    _build.require(series, "series", torch.float32, 2)
    _build.require(breakpoints, "breakpoints", torch.float32, 1)
    _build.same_device(series, breakpoints)
    b, n = series.shape
    if segments <= 0 or n % segments:
        raise ValueError(f"series length {n} not divisible by {segments}")
    if n // segments > 32 * 32:
        raise ValueError("segments longer than 1024 values are not supported")
    if breakpoints.numel() > 255:
        raise ValueError("at most 255 breakpoints (uint8 symbols)")
    if normalize and (segments > 32 or segments & (segments - 1)):
        raise ValueError("normalize=True needs a power-of-two w <= 32")
    shape = tuning.launch_shape("paa_isax", series.device, q=1, n=b,
                                threads=threads)
    sax = torch.empty((b, segments), dtype=torch.uint8, device=series.device)
    paa = torch.empty((b, segments), dtype=torch.float32,
                      device=series.device)
    lib = _build.load()
    err = lib.paa_isax_launch(
        series.data_ptr(), breakpoints.data_ptr(), sax.data_ptr(),
        paa.data_ptr(), b, n, segments, breakpoints.numel(), int(normalize),
        shape["threads"], _build.stream_of(series))
    _build.check(err, "paa_isax")
    launches.add()
    return sax, paa
