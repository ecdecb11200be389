"""ParIS+ core on torch: iSAX math, the flat CSR index, search, the
pipelined build, live ingest, durability and the cold tier."""

from repro_torch.core.block_cache import BlockCache, ColdReader
from repro_torch.core.build_pipeline import (
    BuildStats,
    PipelineBuilder,
    bulk_load_chunk,
    merge_runs,
)
from repro_torch.core.coldtier import (
    ColdShard,
    cold_exact_knn_batch,
    cold_exact_search_batch,
    cold_knn_batch_tiered,
    load_cold_shard,
    make_cold_batch_engine,
)
from repro_torch.core.datagen import SeriesSource, random_walk, write_dataset
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
from repro_torch.core.ingest import (
    CompactionPolicy,
    CompactionResult,
    DeltaShard,
    IngestPipeline,
    IngestStats,
    MutableIndex,
    Snapshot,
    build_delta_shard,
)

__all__ = [
    "BlockCache", "ColdReader",
    "BuildStats", "PipelineBuilder", "bulk_load_chunk", "merge_runs",
    "ColdShard", "cold_exact_knn_batch", "cold_exact_search_batch",
    "cold_knn_batch_tiered", "load_cold_shard", "make_cold_batch_engine",
    "SeriesSource", "random_walk", "write_dataset",
    "CompactionPolicy", "CompactionResult", "DeltaShard", "IngestPipeline",
    "IngestStats", "MutableIndex", "Snapshot", "build_delta_shard",
    "ParISIndex", "ShardedIndex", "assemble_index", "build_index",
    "build_sharded_index", "empty_index", "validate_index",
    "PackedComponents", "SearchConfig", "SearchResult", "Tier",
    "approx_search", "approx_search_batch", "brute_force", "exact_knn",
    "exact_knn_batch", "exact_knn_batch_packed", "exact_search",
    "exact_search_batch", "exact_search_batch_packed", "exact_search_single",
    "knn_batch_packed_tiered", "knn_batch_tiered", "make_batch_engine",
    "merge_top_lists", "nb_exact_search", "pack_components", "packed_seed",
]
