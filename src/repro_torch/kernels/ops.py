"""Dispatch between the hand-written CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``. Every op takes ``impl``:

  * ``"auto"`` — the CUDA kernel for a tensor on the card, the plain
                 PyTorch version for a tensor on the CPU;
  * ``"ref"``  — the plain version wherever the tensor lies (the CPU tests,
                 and ``chip_smoke.py`` comparing a kernel with it on the card).

The device of the tensor decides, nothing else: a CUDA tensor launches the
kernel or raises (no build, a refused launch, an unsupported shape), and
there is no ``try`` that gives way to the plain version. There is no block
tuning table yet; each kernel fixes its launch shape.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import euclidean as _euclid
from repro_torch.kernels import lower_bound as _lb
from repro_torch.kernels import paa_isax as _pi
from repro_torch.kernels import ref as _ref

KERNELS = {"paa_isax": _pi, "lower_bound_sq_batch": _lb,
           "euclid_sq": _euclid}


def _use_kernel(t: torch.Tensor, impl: str) -> bool:
    if impl == "ref":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def launch_counts() -> dict:
    """Kernel launches per kernel since :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod in KERNELS.values():
        mod.launches = 0


def lower_bound_sq(
    query_paa: torch.Tensor,
    sax: torch.Tensor,
    bp_padded: torch.Tensor,
    series_length: int,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """(w,) PAA x (N, w) sax -> (N,) squared lower bounds.

    Plain version only: its kernel (the single-query TPU kernel
    ``_lb_kernel_rows``/``_lb_kernel_cols``) is not ported yet, and the
    main path does not call it.
    """
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    return _ref.lower_bound_sq(query_paa, sax, bp_padded, series_length)


def lower_bound_sq_batch(
    query_paa: torch.Tensor,
    sax: torch.Tensor,
    bp_padded: torch.Tensor,
    series_length: int,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """(Q, w) PAA batch x (N, w) sax -> (Q, N) squared lower bounds."""
    if not _use_kernel(sax, impl):
        return _ref.lower_bound_sq_batch(
            query_paa, sax, bp_padded, series_length)
    return _lb.lower_bound_sq_batch_cuda(
        query_paa.contiguous(), sax, bp_padded, series_length)


def paa_isax(
    series: torch.Tensor,
    breakpoints: torch.Tensor,
    segments: int,
    *,
    impl: str = "auto",
    normalize: bool = True,
) -> tuple:
    """(B, n) raw -> ((B, w) uint8 sax, (B, w) f32 paa)."""
    if not _use_kernel(series, impl):
        return _ref.paa_isax(series, segments, breakpoints, normalize)
    return _pi.paa_isax_cuda(series, breakpoints, segments, normalize)


def euclid_sq_gather(
    queries: torch.Tensor,
    raw: torch.Tensor,
    positions: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """(Q, n) queries x raw rows at positions -> (Q, R) squared distances.

    ``positions`` is (Q, R) per query, or (R,) shared by every query; it is
    clamped to the rows of ``raw`` (``NO_POS`` reads row 0).
    """
    if not _use_kernel(raw, impl):
        if positions.dim() == 1:
            positions = positions[None, :].expand(queries.shape[0], -1)
        return _ref.euclid_sq_gather(queries, raw, positions)
    return _euclid.euclid_sq_gather_cuda(
        queries.contiguous(), raw, positions.to(torch.int32).contiguous())


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
    return _euclid.euclid_sq_gather_cuda(
        query.reshape(1, -1).contiguous(), data, ident)[0]
