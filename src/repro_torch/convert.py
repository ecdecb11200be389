"""Carry an index between the JAX package and the port as numpy arrays.

``index_from_arrays`` takes the four arrays of a ParIS index (for example
``np.asarray(jax_index.sax)`` and friends) and returns the port's
:class:`~repro_torch.core.index.ParISIndex` on ``device``;
``index_to_arrays`` goes the other way. Neither imports JAX: the arrays are
plain numpy, so the tests can run both engines over one identical index.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.index import ParISIndex


def index_from_arrays(sax, pos, bucket_offsets, raw, series_length: int,
                      segments: int, cardinality: int,
                      device="cuda") -> ParISIndex:
    """numpy arrays (sorted SAX, pos, offsets, file-order raw) -> index."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    index = ParISIndex(
        sax=put(sax, torch.uint8),
        pos=put(pos, torch.int32),
        bucket_offsets=put(bucket_offsets, torch.int32),
        raw=put(raw, torch.float32),
        series_length=int(series_length),
        segments=int(segments),
        cardinality=int(cardinality),
    )
    n = index.num_series
    if index.sax.shape != (n, index.segments):
        raise ValueError(f"sax shape {tuple(index.sax.shape)} != ({n}, "
                         f"{index.segments})")
    if index.pos.shape != (n,) or index.raw.shape != (n, index.series_length):
        raise ValueError("pos/raw do not match the sax rows")
    if index.bucket_offsets.shape != (2 ** index.segments + 1,):
        raise ValueError("bucket_offsets must have 2**segments + 1 entries")
    return index


def index_to_arrays(index: ParISIndex) -> dict:
    """The index's arrays as host numpy arrays plus its static sizes."""
    return dict(
        sax=index.sax.cpu().numpy(),
        pos=index.pos.cpu().numpy(),
        bucket_offsets=index.bucket_offsets.cpu().numpy(),
        raw=index.raw.cpu().numpy(),
        series_length=index.series_length,
        segments=index.segments,
        cardinality=index.cardinality,
    )
