"""The frozen least work of the live store's kernel, beside ``cost``'s.

``lower_bound_sq_multi`` sweeps the packed view: every component's rows
padded to whole blocks, and about an eighth more dead capacity. A correct
kernel needs only the real rows, so the count is ``cost.lb_batch_work``'s
over the store's series: the dead capacity and the block pads it sweeps
count as waste, and read in its share of the roofline.
"""

from __future__ import annotations

from portbench import cost


def lb_multi_work(queries: int, num_series: int, segments: int) -> tuple:
    """(FLOP, bytes) of one ``lower_bound_sq_multi`` over a store of
    ``num_series`` real rows: their (rows, w) uint8 SAX and the (queries,
    w) float32 PAA read once, the (queries, rows) float32 bounds written
    once; one operation a (query, row, segment)."""
    return cost.lb_batch_work(queries, num_series, segments)
