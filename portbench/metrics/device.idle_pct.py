"""``device.idle_pct.<cells>``: the share of the traced window in which no
operation ran on the device (the window less the union of the device
operations' intervals). One quantity, split by the end-to-end metric it
moves: ``.batch``, ``.single``."""


def read(record):
    """Percent idle, or None where no device operation ran."""
    if record["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
