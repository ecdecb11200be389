"""ParIS+ core on torch: iSAX math, the flat CSR index, search."""

from repro_torch.core.datagen import random_walk
from repro_torch.core.index import (
    ParISIndex,
    ShardedIndex,
    assemble_index,
    build_index,
    build_sharded_index,
    empty_index,
    validate_index,
)
from repro_torch.core.search import (
    PackedComponents,
    SearchConfig,
    SearchResult,
    Tier,
    approx_search,
    approx_search_batch,
    brute_force,
    exact_knn,
    exact_knn_batch,
    exact_knn_batch_packed,
    exact_search,
    exact_search_batch,
    exact_search_batch_packed,
    exact_search_single,
    knn_batch_packed_tiered,
    knn_batch_tiered,
    make_batch_engine,
    merge_top_lists,
    nb_exact_search,
    pack_components,
    packed_seed,
)

__all__ = [
    "random_walk",
    "ParISIndex", "ShardedIndex", "assemble_index", "build_index",
    "build_sharded_index", "empty_index", "validate_index",
    "PackedComponents", "SearchConfig", "SearchResult", "Tier",
    "approx_search", "approx_search_batch", "brute_force", "exact_knn",
    "exact_knn_batch", "exact_knn_batch_packed", "exact_search",
    "exact_search_batch", "exact_search_batch_packed", "exact_search_single",
    "knn_batch_packed_tiered", "knn_batch_tiered", "make_batch_engine",
    "merge_top_lists", "nb_exact_search", "pack_components", "packed_seed",
]
