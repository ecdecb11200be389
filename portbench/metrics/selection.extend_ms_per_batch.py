"""``selection.extend_ms_per_batch``: device time of the candidate list's
extensions, per batch of the window: what was launched under the
program's ``paris.engine.select.extend`` span, the sorts of the list past
its first prefix. Every extension also runs under ``paris.engine.select``,
so ``selection.ms_per_batch`` counts it too.

A program that orders its list lazily launches ``repro_torch::order_range``
in every batch; where it did and no extension ran, the reading is 0.0. A
program without that operator (one that sorts the whole list at once)
has nothing to read here.
"""

EXTEND = "paris.engine.select.extend"
LAZY = "repro_torch::order_range"


def read(record):
    """Milliseconds a batch, 0.0 where no extension ran, or None where the
    program does not order its list lazily or no batch ran."""
    ops = record["ops"]
    batches = record["counters"].get("batches")
    if not batches or not ops.get(LAZY):
        return None
    return ops.get(EXTEND, 0.0) / 1e3 / batches
