from repro_torch.kernels.rpc_channel.kernel import (Channel, Staging,
                                                    channel_for, channels,
                                                    rpc_post)

__all__ = ["Channel", "Staging", "channel_for", "channels", "rpc_post"]
