"""95th percentile of the gaps between a request's successive output
tokens, over every gap that ended in the window."""
from harness.common import percentile_ms


def read(run):
    return percentile_ms(run["itl_s"], 95)
