from repro_torch.kernels.paged_attention.ops import paged_decode_attention

__all__ = ["paged_decode_attention"]
