"""Datasets for the paper's experiments, numpy only (a copy of
``repro/core/datagen.py``).

The paper's synthetic benchmark is a Gaussian random walk; real datasets
(Seismic, SALD) are not redistributable, so the builder accepts any float32
(N, n) array or raw file through :class:`SeriesSource`. The tests make
their inputs with :func:`random_walk` and hand the same arrays to both
packages; ``chip_smoke.py`` makes its full-size data on the card instead.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def random_walk(
    num_series: int, length: int = 256, seed: int = 0, chunk: int = 65536
) -> np.ndarray:
    """Paper's generator: steps ~ N(0,1), cumulatively summed per series."""
    rng = np.random.default_rng(seed)
    out = np.empty((num_series, length), np.float32)
    for s in range(0, num_series, chunk):
        e = min(s + chunk, num_series)
        out[s:e] = rng.standard_normal((e - s, length), np.float32).cumsum(axis=1)
    return out


def write_dataset(path: str, num_series: int, length: int = 256, seed: int = 0,
                  chunk: int = 65536) -> None:
    """Stream a random-walk dataset to a raw float32 file (the 'disk file')."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for s in range(0, num_series, chunk):
            e = min(s + chunk, num_series)
            f.write(
                rng.standard_normal((e - s, length), np.float32)
                .cumsum(axis=1).astype(np.float32).tobytes()
            )


@dataclasses.dataclass
class SeriesSource:
    """Chunked reader over the raw data file (what the Coordinator reads).

    ``read(i)`` returns (chunk ndarray, start offset); chunks are fixed-size
    except the last. Backed by an in-memory array or a np.memmap. The
    chunks stay on the host: the builder copies each one to its device.
    """

    data: np.ndarray  # (N, n) float32, file order
    chunk_series: int = 8192

    @classmethod
    def from_array(cls, arr, chunk_series: int = 8192) -> "SeriesSource":
        """Wrap an in-memory (N, n) array as a chunked source."""
        return cls(np.asarray(arr, np.float32), chunk_series)

    @classmethod
    def from_file(cls, path: str, length: int = 256,
                  chunk_series: int = 8192) -> "SeriesSource":
        """Memory-map a packed float32 series file as a chunked source."""
        n_bytes = os.path.getsize(path)
        num = n_bytes // (4 * length)
        mm = np.memmap(path, np.float32, "r", shape=(num, length))
        return cls(mm, chunk_series)

    @property
    def num_series(self) -> int:
        """Number of series in the source."""
        return self.data.shape[0]

    @property
    def length(self) -> int:
        """Per-series length n."""
        return self.data.shape[1]

    @property
    def num_chunks(self) -> int:
        """Number of read chunks (ceil of num_series / chunk_series)."""
        return -(-self.num_series // self.chunk_series)

    def read(self, i: int):
        """Read chunk ``i``; returns (chunk array, starting file offset)."""
        s = i * self.chunk_series
        e = min(s + self.chunk_series, self.num_series)
        # np.array(...) forces the actual "disk read" (memmap page-in + copy).
        return np.array(self.data[s:e]), s
