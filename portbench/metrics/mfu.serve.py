"""Useful model FLOPs of the window over its seconds at the H100's dense
bf16 peak: 2 a published matmul weight a token processed (prompt and
output; real heads, routed experts, the head) and attention over each
token's context.  Card runs only."""
from harness.common import H100_BF16_FLOPS
from harness.costs import serve_flops
from harness.modelcfg import head_dim


def read(run):
    if "context_sum" not in run or run["peak_bytes"] is None:
        return None
    c = run["conf"]
    flops = serve_flops(run["matmul_params"], run["processed"],
                        run["context_sum"], int(c["num_hidden_layers"]),
                        int(c["num_attention_heads"]), head_dim(c))
    return 100.0 * flops / (run["window_s"] * H100_BF16_FLOPS)
