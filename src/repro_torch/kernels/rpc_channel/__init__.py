from repro_torch.kernels.rpc_channel.kernel import (Channel, HostChannel,
                                                    HostStaging, Staging,
                                                    channel_for, channels,
                                                    host_channel, rpc_post)
from repro_torch.kernels.rpc_channel.ops import post

__all__ = ["Channel", "HostChannel", "HostStaging", "Staging", "channel_for",
           "channels", "host_channel", "post", "rpc_post"]
