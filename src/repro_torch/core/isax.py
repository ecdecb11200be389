"""iSAX representation math on torch tensors: PAA, symbols, breakpoints, bounds.

Counterpart of ``repro/core/isax.py``. Same conventions: a data series is a
length-``n`` float32 vector (z-normalized), PAA keeps the means of ``w``
equal segments, each PAA value maps to one of ``card`` N(0,1) regions, the
root key packs the most significant bit of each symbol, and the squared
PAA-to-iSAX lower bound never exceeds the squared Euclidean distance.

Three choices here keep z-norms, PAA and symbols bit-identical to the JAX
package on the CPU:

  * breakpoints come from the committed float32 table
    (:mod:`repro_torch.core._breakpoints`), not from ``torch.special.ndtri``;
  * every sum over the last axis (:func:`sum_last`) is taken in the order
    XLA's CPU compiler uses: windows of 32 summed left to right, then the
    window totals the same way;
  * the z-norm's square root is taken in float64 and rounded to float32,
    which is the correctly rounded float32 root (PyTorch's vectorized
    float32 ``sqrt`` on the CPU is not).

Everything works on arbitrary leading batch dimensions.
"""

from __future__ import annotations

import torch

from repro_torch.core._breakpoints import BREAKPOINTS

# Paper defaults: w = 16 segments, 8-bit symbols (cardinality 256), n = 256.
DEFAULT_SEGMENTS = 16
DEFAULT_CARDINALITY = 256
DEFAULT_SERIES_LENGTH = 256

# Sentinel magnitude standing in for +/- infinity in padded breakpoint tables.
# Finite so that arithmetic on pruned branches stays NaN-free inside kernels.
BIG = 1e9


def gaussian_breakpoints(cardinality: int = DEFAULT_CARDINALITY,
                         device="cpu") -> torch.Tensor:
    """The ``cardinality - 1`` interior N(0,1) quantile breakpoints (float32)."""
    if cardinality not in BREAKPOINTS:
        raise ValueError(
            f"cardinality {cardinality} has no committed breakpoint table "
            f"(powers of two from 2 to 256: {sorted(BREAKPOINTS)})")
    return torch.tensor(BREAKPOINTS[cardinality], dtype=torch.float32,
                        device=device)


def padded_breakpoints(cardinality: int = DEFAULT_CARDINALITY,
                       device="cpu") -> torch.Tensor:
    """Breakpoints padded with +/-BIG: ``bp[s] .. bp[s+1]`` bounds symbol ``s``."""
    bp = gaussian_breakpoints(cardinality, device)
    big = torch.tensor([BIG], dtype=torch.float32, device=device)
    return torch.cat([-big, bp, big])


SUM_WINDOW = 32  # XLA CPU splits longer reductions into windows of 32


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the reference's (XLA CPU's) order.

    A sum longer than ``SUM_WINDOW`` is cut into windows of 32 (the last one
    zero-padded), each summed left to right; the window totals are summed
    the same way, recursively. Shorter sums run left to right.
    """
    n = x.shape[-1]
    if n <= SUM_WINDOW:
        return _sum_in_order(x)
    pad = (-n) % SUM_WINDOW
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return sum_last(_sum_in_order(x.reshape(*x.shape[:-1], -1, SUM_WINDOW)))


def znorm(series: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Z-normalize each series along the last axis (population std + eps)."""
    n = series.shape[-1]
    centered = series - (sum_last(series) / n)[..., None]
    var = sum_last(centered * centered) / n
    sd = torch.sqrt(var.double()).to(series.dtype)  # correctly rounded
    return centered / (sd[..., None] + eps)


def paa(series: torch.Tensor, segments: int = DEFAULT_SEGMENTS) -> torch.Tensor:
    """Piecewise Aggregate Approximation: segment means along the last axis.

    Each segment is summed in :func:`sum_last`'s order and divided by its
    length; the ``paa_isax`` kernel sums in the same order.
    """
    *lead, n = series.shape
    if n % segments:
        raise ValueError(f"series length {n} not divisible by {segments} segments")
    seg = n // segments
    return sum_last(series.reshape(*lead, segments, seg)) / seg


def sax_from_paa(paa_values: torch.Tensor,
                 cardinality: int = DEFAULT_CARDINALITY) -> torch.Tensor:
    """Map PAA values to iSAX symbols: the count of breakpoints strictly below.

    ``searchsorted(side="left")`` returns exactly that count, without the
    (..., card - 1) comparison the reference broadcasts.
    """
    bp = gaussian_breakpoints(cardinality, paa_values.device)
    sym = torch.searchsorted(bp, paa_values.contiguous(), side="left")
    return sym.to(torch.uint8 if cardinality <= 256 else torch.int32)


def convert_to_sax(
    series: torch.Tensor,
    segments: int = DEFAULT_SEGMENTS,
    cardinality: int = DEFAULT_CARDINALITY,
    normalize: bool = True,
) -> tuple:
    """The paper's ConvertToSAX: series -> (sax symbols, paa). Batched."""
    if normalize:
        series = znorm(series)
    p = paa(series, segments)
    return sax_from_paa(p, cardinality), p


def _bit_weights(w: int, device) -> torch.Tensor:
    return 2 ** torch.arange(w - 1, -1, -1, dtype=torch.int64, device=device)


def root_key(sax: torch.Tensor,
             cardinality: int = DEFAULT_CARDINALITY) -> torch.Tensor:
    """Pack the MSB of each of the ``w`` symbols into one int32 in [0, 2**w).

    Segment 0 is the most significant bit. The reference does this in uint32;
    torch has no uint32 arithmetic, so the bits are packed in int64.
    """
    bits_per_symbol = (cardinality - 1).bit_length()
    msb = (sax.to(torch.int64) >> (bits_per_symbol - 1)) & 1
    weights = _bit_weights(sax.shape[-1], sax.device)
    return (msb * weights).sum(dim=-1).to(torch.int32)


def refine_keys(sax: torch.Tensor, bits: int,
                cardinality: int = DEFAULT_CARDINALITY) -> list:
    """Bit-plane-interleaved refinement keys (int64), most-significant first.

    Plane ``p`` packs the ``p``-th bit of every symbol into one integer
    (plane 0 is :func:`root_key`). Sorting stably by these keys from the
    last plane to the first yields the leaf order of a fully split ADS+ tree.
    """
    bits_per_symbol = (cardinality - 1).bit_length()
    if bits > bits_per_symbol:
        raise ValueError(f"bits={bits} exceeds symbol width {bits_per_symbol}")
    w = sax.shape[-1]
    if w > 32:
        raise ValueError(f"w={w} > 32 unsupported")
    s = sax.to(torch.int64)
    weights = _bit_weights(w, sax.device)
    keys = []
    for plane in range(bits):  # MSB plane first
        plane_bits = (s >> (bits_per_symbol - 1 - plane)) & 1
        keys.append((plane_bits * weights).sum(dim=-1))
    return keys


def symbol_bounds(sax: torch.Tensor,
                  cardinality: int = DEFAULT_CARDINALITY) -> tuple:
    """(lower, upper) breakpoint bounds of each symbol's region; +/-BIG at ends."""
    bp = padded_breakpoints(cardinality, sax.device)
    idx = sax.to(torch.int64)
    return bp[idx], bp[idx + 1]


def lower_bound_sq(
    query_paa: torch.Tensor,
    sax: torch.Tensor,
    series_length: int = DEFAULT_SERIES_LENGTH,
    cardinality: int = DEFAULT_CARDINALITY,
) -> torch.Tensor:
    """Squared PAA-to-iSAX lower bound (paper §3.3.1, reference formulation).

    Shapes: query_paa (..., w) against sax (N, w) -> (..., N).
    """
    w = sax.shape[-1]
    bl, bu = symbol_bounds(sax, cardinality)  # (N, w) each
    q = query_paa[..., None, :]  # (..., 1, w)
    zero = torch.zeros((), dtype=torch.float32, device=sax.device)
    d = torch.where(q > bu, q - bu, torch.where(q < bl, bl - q, zero))
    return (series_length / w) * sum_last(d * d)


def euclid_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance along the last axis (broadcasting)."""
    d = a - b
    return sum_last(d * d)


def batched_euclid_sq(queries: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(Q, n) x (N, n) -> (Q, N) by the |a|^2 - 2ab + |b|^2 form.

    Counterpart of ``repro/core/isax.py::batched_euclid_sq``, with the
    cross term a ``torch.matmul`` (in full float32: the caller keeps TF32
    off, as PyTorch does by default). The reference wrote it for the TPU's
    matrix unit; it rounds differently from the direct difference sum
    (:func:`euclid_sq`, the ``euclid_sq`` kernel), so the engine does not
    use it, and its results match the reference's to the product's
    rounding, not bit for bit.
    """
    qn = sum_last(queries * queries)[:, None]  # (Q, 1)
    dn = sum_last(data * data)  # (N,)
    cross = torch.matmul(queries, data.T)  # (Q, N)
    return torch.clamp_min(qn - 2.0 * cross + dn[None, :], 0.0)
