"""``euclid_roofline``: the frozen least time of the window's
``euclid_sq`` work (the rows the engine needed, its reads, and each
launch's queries, ``cost.euclid_work``) over the device time of the
``euclid_gather_kernel`` launches."""

from portbench import cost

NAME = "euclid_gather_kernel"


def read(record):
    """Percent of the roofline, or None where the kernel did not run."""
    c, p = record["counters"], record["params"]
    times = [e - s for n, s, e in record["kernels"] if NAME in n]
    if not times or not c.get("reads"):
        return None
    least = cost.least_seconds(*cost.euclid_work(
        c["reads"], p["series_length"], len(times), c["batch"]))
    return cost.roofline_pct(least, sum(times) / 1e6)
