"""95th percentile of submission to the end of the tick that returned the
first token, over every request whose first token came in the window (a
client's first, staggered request excluded).  The reader of
``ttft_p95_ms.open``."""
from harness.common import percentile_ms


def read(run):
    return percentile_ms(run["ttft_s"], 95)
