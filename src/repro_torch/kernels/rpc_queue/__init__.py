from repro_torch.kernels.rpc_queue.kernel import rpc_enqueue
from repro_torch.kernels.rpc_queue.ops import enqueue, geometry, lanes_of
from repro_torch.kernels.rpc_queue.ref import (Arg, Lanes, Record,
                                               enqueue_reference)

__all__ = ["Arg", "Lanes", "Record", "enqueue", "enqueue_reference",
           "geometry", "lanes_of", "rpc_enqueue"]
