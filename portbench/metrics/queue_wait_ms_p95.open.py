"""95th percentile of the wait from a request's due time to the tick that
admitted it to a slot (the engine's queue and its refill), over every
request admitted in the window (the first wave excluded)."""
from harness.common import percentile_ms


def read(run):
    return percentile_ms(run["queue_wait_s"], 95)
