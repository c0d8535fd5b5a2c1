from repro_torch.kernels.rpc_async.kernel import (AsyncRing,
                                                  rpc_async_collect,
                                                  rpc_async_post)
from repro_torch.kernels.rpc_async.ref import (collect_reference,
                                               post_reference)

__all__ = ["AsyncRing", "collect_reference", "post_reference",
           "rpc_async_collect", "rpc_async_post"]
