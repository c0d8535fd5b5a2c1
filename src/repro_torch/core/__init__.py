"""GPU First core, ported so far: the balanced allocator (paper §3.4), the
device ``rand`` of the libc and the device main loop with immediate hooks
(paper §3.1)."""
from repro_torch.core.allocator import (
    DEAD, FAIL, BalancedAllocator, BalancedState)
from repro_torch.core.device_main import HostHook, device_run

__all__ = ["DEAD", "FAIL", "BalancedAllocator", "BalancedState", "HostHook",
           "device_run"]
