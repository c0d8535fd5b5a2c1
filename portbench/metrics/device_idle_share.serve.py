"""1 - the union of the device's operation intervals in the traced ticks
over the traced window's wall time (overlapping kernels count once)."""


def read(run):
    tr = run.get("trace")
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
