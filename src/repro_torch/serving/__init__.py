"""The serving fabric over the port's engines: batcher, router, live ingest.

Retrieval serving architecture (the JAX package's ``repro.serving``, with
the same names, counters and ``stats()`` keys)::

    submit(query)                      one Future per request (numpy rows)
        |
    ShardedSearchRouter                fan-out + global merge on the host
        |                              (router.py): file-order shards held
        |  per-shard fan-out           by R replicas, health-gated p2c
        v                              placement, hedging, one sibling
    SearchRequestBatcher  x S x R      retry, deadlines, tier degradation
        |                              (TierDegradePolicy)
        |  bounded pending queue       admission control: block / reject /
        |  (max_pending + policy)      shed-oldest
        v
    make_batch_engine(shard)  x S      ONE engine per shard, shared by its
        |                              replicas; a cohort is uploaded once
        v                              and its answers copied back once
    the RDC engine core on the card    lower_bound_sq_batch + euclid_sq

Live ingestion rides the same stack (ingest.py): ``IngestingRouter``
appends batches to a ``MutableIndex`` (Stage 2 runs ``paa_isax`` on the
store's device), registers each delta as a routed shard, and rewires
compactions in one atomic ``swap_shards``. A cold-tier ``ColdShard`` is a
routable shard with a disk-backed engine.

Fault model (health.py, faults.py): per-replica EWMA latency and a
breaker with a half-open probe; ``FaultInjector`` rules bite every
replica's flush and the compaction daemon. Under any fault schedule an
answer is bit-exact or a typed error (``QueueFullError``,
``DeadlineExceededError``, ``ShardFailedError``), never a hang.

The decode side of LM serving lives beside it: ``kv_cache``
(``pad_cache_to``), ``serve_step`` (``greedy_generate``) and ``batcher``
(``SlotBatcher``), over ``repro_torch.models``.
"""

from repro_torch.core.search import Tier
from repro_torch.serving.faults import FaultInjector, InjectedFaultError
from repro_torch.serving.health import ReplicaHealth, choose_replica
from repro_torch.serving.ingest import IngestingRouter
from repro_torch.serving.router import (
    ShardedSearchRouter, ShardFailedError, TierDegradePolicy)
from repro_torch.serving.search_batcher import (
    DeadlineExceededError, QueueFullError, RequestShedError,
    SearchRequestBatcher)

__all__ = ["FaultInjector", "InjectedFaultError", "ReplicaHealth",
           "choose_replica", "IngestingRouter", "DeadlineExceededError",
           "QueueFullError", "RequestShedError", "SearchRequestBatcher",
           "ShardedSearchRouter", "ShardFailedError", "Tier",
           "TierDegradePolicy"]
