from repro_torch.kernels.rpc_queue.kernel import rpc_enqueue
from repro_torch.kernels.rpc_queue.ref import (Arg, Lanes, Record,
                                               enqueue_reference)

__all__ = ["Arg", "Lanes", "Record", "enqueue_reference", "rpc_enqueue"]
