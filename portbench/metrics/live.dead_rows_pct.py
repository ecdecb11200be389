"""``live.dead_rows_pct``: rows of the live store's packed view that hold
no series (dead capacity and block pads), as a share of the series: 100 x
(``packed_rows`` - ``num_series``) / ``num_series``. Every batch's bound
pass and selection sweep them."""


def read(record):
    """Percent, or None where the program reports no packed view."""
    c = record["counters"]
    if not c.get("packed_rows") or not c.get("num_series"):
        return None
    return 100.0 * (c["packed_rows"] - c["num_series"]) / c["num_series"]
