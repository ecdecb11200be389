"""ParIS+ core on torch: iSAX math, the flat CSR index, search."""

from repro_torch.core.datagen import random_walk
from repro_torch.core.index import (
    ParISIndex,
    assemble_index,
    build_index,
    empty_index,
    validate_index,
)
from repro_torch.core.search import (
    SearchConfig,
    SearchResult,
    Tier,
    approx_search,
    approx_search_batch,
    exact_knn,
    exact_knn_batch,
    exact_search,
    exact_search_batch,
    knn_batch_tiered,
    make_batch_engine,
    merge_top_lists,
)

__all__ = [
    "random_walk",
    "ParISIndex", "assemble_index", "build_index", "empty_index",
    "validate_index",
    "SearchConfig", "SearchResult", "Tier", "approx_search",
    "approx_search_batch", "exact_knn", "exact_knn_batch", "exact_search",
    "exact_search_batch", "knn_batch_tiered", "make_batch_engine",
    "merge_top_lists",
]
