"""``selection.ms_per_batch``: device time of the engine's candidate
selection, per batch of the window: what was launched under the program's
``paris.engine.select`` span, whatever runs the selection. A trace without
that span (a program that marks no steps) reads ``aten::topk``, which was
the whole selection there, so the reading does not depend on whether the
program marks its steps."""


def read(record):
    """Milliseconds a batch, or None where no selection or no batch ran."""
    ops = record["ops"]
    us = ops.get("paris.engine.select", ops.get("aten::topk", 0.0))
    batches = record["counters"].get("batches")
    if not us or not batches:
        return None
    return us / 1e3 / batches
