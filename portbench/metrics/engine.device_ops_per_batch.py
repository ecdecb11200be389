"""``engine.device_ops_per_batch.<cells>``: the device operations of the
traced window (every kernel and copy the profiler saw, ``record
["kernels"]``) per batch of the window. Each launch of a round body costs
the host a launch and the device a short operation, so this counts what
the host had to send for a batch. One quantity, split by the end-to-end
metric it moves: ``.batch``, ``.live``."""


def read(record):
    """Device operations over batches, or None where no batch ran."""
    c = record["counters"]
    if not c.get("batches"):
        return None
    return len(record["kernels"]) / c["batches"]
