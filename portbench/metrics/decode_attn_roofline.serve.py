"""The paged decode attention's least time over its device time in the
traced ticks.  The least time is the larger of the bytes it must move
(each active slot's K/V context once, its query, its output and its page
row: ``harness/costs.py``) over 3.35 TB/s and its FLOPs over 989 TFLOP/s;
the device time is that of the kernels named below."""
from harness.common import H100_BF16_FLOPS, H100_HBM_BYTES_S
from harness.trace import seconds_of

#: The paged decode's kernels (``csrc/decode_common.cuh``): one launch at
#: G <= 8 in bf16, the split and merge kernels otherwise.
KERNELS = ("decode_fused_mma", "decode_fused", "split_mma", "merge_kernel")


def read(run):
    tr = run.get("trace")
    if tr is None or "decode_attn" not in run:
        return None
    t = seconds_of(tr, KERNELS)
    if t <= 0:
        return None
    w = run["decode_attn"]
    least = max(w["bytes"] / H100_HBM_BYTES_S, w["flops"] / H100_BF16_FLOPS)
    return 100.0 * least / t
