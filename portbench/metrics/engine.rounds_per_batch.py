"""``engine.rounds_per_batch.<cells>``: rounds of the engine's loop, one
host round trip each, per batch of the window (``exact_knn_batch``'s
``stats=True`` rounds; the exactness fallback's rounds included). One
quantity, split by the end-to-end metric it moves: ``.batch``."""


def read(record):
    """Rounds over batches, or None where no batch ran."""
    c = record["counters"]
    if not c.get("batches") or "rounds" not in c:
        return None
    return c["rounds"] / c["batches"]
