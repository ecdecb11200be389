"""``lb_multi_roofline``: the frozen least time of the window's
``lower_bound_sq_multi`` passes (one (batch, N) pass a batch over the
store's real rows, ``cost_live.lb_multi_work``) over the device time of the
``lb_kernel`` launches of the masked form (template form 1)."""

import re

from portbench import cost, cost_live

NAME = re.compile(r"lb_kernel<\d+, 1,")


def read(record):
    """Percent of the roofline, or None where the kernel did not run."""
    c, p = record["counters"], record["params"]
    device_s = sum(e - s for n, s, e in record["kernels"]
                   if NAME.search(n)) / 1e6
    if not c.get("batches") or device_s <= 0:
        return None
    least = c["batches"] * cost.least_seconds(*cost_live.lb_multi_work(
        c["batch"], p["num_series"], p["segments"]))
    return cost.roofline_pct(least, device_s)
