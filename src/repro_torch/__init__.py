"""ParIS+ data-series indexing on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``repro``: the same index, the same engine and
the same answers, with the TPU's Pallas kernels replaced by CUDA kernels
written for the H100. It imports no JAX. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""

from repro_torch.convert import index_from_arrays, index_to_arrays
from repro_torch.core import (
    ParISIndex,
    SearchConfig,
    SearchResult,
    Tier,
    build_index,
    exact_knn,
    exact_knn_batch,
    exact_search,
    exact_search_batch,
    knn_batch_tiered,
    make_batch_engine,
)

__all__ = [
    "index_from_arrays", "index_to_arrays",
    "ParISIndex", "SearchConfig", "SearchResult", "Tier", "build_index",
    "exact_knn", "exact_knn_batch", "exact_search", "exact_search_batch",
    "knn_batch_tiered", "make_batch_engine",
]
