from repro_torch.kernels.rpc_channel.kernel import (COPY_LIMIT, ENGINE, KERNEL,
                                                    MAX_SLOTS, Channel,
                                                    HostChannel, HostStaging,
                                                    Launch, Staging,
                                                    channel_for, channels,
                                                    host_channel, rpc_post)
from repro_torch.kernels.rpc_channel.ops import post

__all__ = ["COPY_LIMIT", "ENGINE", "KERNEL", "MAX_SLOTS", "Channel",
           "HostChannel", "HostStaging", "Launch", "Staging", "channel_for",
           "channels", "host_channel", "post", "rpc_post"]
