from repro_torch.kernels.rpc_async.kernel import (AsyncFlushPlan, AsyncRing,
                                                  pack_flush, ring_by_id,
                                                  rpc_async_collect,
                                                  rpc_async_post)
from repro_torch.kernels.rpc_async.ops import (async_collect, async_post,
                                               collect_plain, post_plain)
from repro_torch.kernels.rpc_async.ref import (collect_reference,
                                               post_reference)

__all__ = ["AsyncFlushPlan", "AsyncRing", "async_collect", "async_post",
           "collect_plain", "collect_reference", "pack_flush", "post_plain",
           "post_reference", "ring_by_id", "rpc_async_collect",
           "rpc_async_post"]
