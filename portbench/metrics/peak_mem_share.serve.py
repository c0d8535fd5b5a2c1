"""``max_memory_allocated`` over the window (reset as it opens) over the
card's memory."""


def read(run):
    if run["peak_bytes"] is None:
        return None
    return 100.0 * run["peak_bytes"] / run["device_total_bytes"]
