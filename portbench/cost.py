"""The frozen yardstick of the kernels: the H100's published peaks and the
least work each kernel's contract needs.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at the
full 700 W), 3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor
cores. A share of the roofline is the least time the chip could take (the
larger of operations over peak FLOP/s and bytes over peak bytes/s) over the
measured device time.

The counts are of what a correct kernel must read, compute and write, not
of the instructions today's kernels issue, so no correct implementation
reads over 100%. They take shapes and counts, never a tensor.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
F32 = 4  # bytes of a float32


def least_seconds(flop: float, nbytes: float) -> float:
    """The least time of a kernel: max(FLOP / peak, bytes / peak)."""
    return max(flop / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def lb_batch_work(queries: int, rows: int, segments: int) -> tuple:
    """(FLOP, bytes) of one ``lower_bound_sq_batch`` over (queries, rows):
    the (rows, w) uint8 SAX and the (queries, w) float32 PAA read once, the
    (queries, rows) float32 bounds written once; one operation a (query,
    row, segment)."""
    flop = queries * rows * segments
    nbytes = rows * segments + queries * segments * F32 + queries * rows * F32
    return flop, nbytes


def euclid_work(reads: int, length: int, launches: int, queries: int
                ) -> tuple:
    """(FLOP, bytes) of the ``euclid_sq`` launches that read ``reads``
    series of ``length`` floats in all (the rows the engine needed), each
    launch reading its (queries, length) queries once; two operations an
    element read."""
    flop = 2 * reads * length
    nbytes = reads * length * F32 + launches * queries * length * F32
    return flop, nbytes


def roofline_pct(least_s: float, device_s: float):
    """100 x least time / device time, or None where nothing ran."""
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
