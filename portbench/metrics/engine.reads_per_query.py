"""``engine.reads_per_query.<cells>``: series whose distance the engine
computed, per query, over the window's batches (``exact_knn_batch``'s
``stats=True`` reads, the paper's pruning count). One quantity, split by
the end-to-end metric it moves: ``.batch``."""


def read(record):
    """Reads over queries, or None where no batch ran."""
    c = record["counters"]
    if not c.get("queries") or "reads" not in c:
        return None
    return c["reads"] / c["queries"]
