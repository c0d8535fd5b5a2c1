"""Median of the host clock around each ``ServingEngine.step`` of the
window (the step's one device-to-host copy ends it).  The reader of
``tick_ms_p50.serve`` (over capacity, moving ``serve_tok_s``) and of
``tick_ms_p50.open`` (below it, moving ``itl_p95_ms``)."""
from harness.common import percentile_ms


def read(run):
    return percentile_ms(run["tick_s"], 50)
