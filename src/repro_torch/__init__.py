"""ParIS+ data-series indexing on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``repro``: the same index, the same engine and
the same answers, with the TPU's Pallas kernels replaced by CUDA kernels
written for the H100. It imports no JAX. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""

from repro_torch.convert import (
    cache_from_arrays,
    dist_index_from_arrays,
    index_from_arrays,
    index_to_arrays,
    model_from_arrays,
    packed_from_arrays,
    packed_to_arrays,
)
from repro_torch.core import (
    BlockCache,
    BuildStats,
    ColdReader,
    ColdShard,
    CompactionPolicy,
    CompactionResult,
    DeltaShard,
    IngestPipeline,
    MutableIndex,
    PipelineBuilder,
    SeriesSource,
    build_delta_shard,
    cold_exact_knn_batch,
    cold_exact_search_batch,
    cold_knn_batch_tiered,
    load_cold_shard,
    make_cold_batch_engine,
    PackedComponents,
    ParISIndex,
    SearchConfig,
    SearchResult,
    Tier,
    brute_force,
    build_index,
    build_sharded_index,
    exact_knn,
    exact_knn_batch,
    exact_knn_batch_packed,
    exact_search,
    exact_search_batch,
    exact_search_single,
    knn_batch_packed_tiered,
    knn_batch_tiered,
    make_batch_engine,
    nb_exact_search,
    pack_components,
    packed_seed,
)
from repro_torch.serving import (
    IngestingRouter,
    SearchRequestBatcher,
    ShardedSearchRouter,
)

__all__ = [
    "cache_from_arrays", "model_from_arrays",
    "dist_index_from_arrays", "index_from_arrays", "index_to_arrays",
    "packed_from_arrays", "packed_to_arrays",
    "PackedComponents", "ParISIndex", "SearchConfig", "SearchResult", "Tier",
    "brute_force", "build_index", "build_sharded_index", "exact_knn",
    "exact_knn_batch", "exact_knn_batch_packed", "exact_search",
    "exact_search_batch", "exact_search_single", "knn_batch_packed_tiered",
    "knn_batch_tiered", "make_batch_engine", "nb_exact_search",
    "pack_components", "packed_seed",
    "BlockCache", "BuildStats", "ColdReader", "ColdShard",
    "CompactionPolicy", "CompactionResult", "DeltaShard", "IngestPipeline",
    "MutableIndex", "PipelineBuilder", "SeriesSource", "build_delta_shard",
    "cold_exact_knn_batch", "cold_exact_search_batch",
    "cold_knn_batch_tiered", "load_cold_shard", "make_cold_batch_engine",
    "IngestingRouter", "SearchRequestBatcher", "ShardedSearchRouter",
]
