"""``selection.topk_ms_per_batch``: device time of the kernels under
``aten::topk`` (the engine's ``_smallest``), per batch of the window."""


def read(record):
    """Milliseconds a batch, or None where no topk or no batch ran."""
    us = record["ops"].get("aten::topk", 0.0)
    batches = record["counters"].get("batches")
    if not us or not batches:
        return None
    return us / 1e3 / batches
