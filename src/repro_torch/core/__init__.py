"""GPU First core, ported so far: the balanced allocator (paper §3.4)."""
from repro_torch.core.allocator import (
    DEAD, FAIL, BalancedAllocator, BalancedState)

__all__ = ["DEAD", "FAIL", "BalancedAllocator", "BalancedState"]
