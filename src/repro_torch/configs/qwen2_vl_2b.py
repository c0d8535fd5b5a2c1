"""qwen2-vl-2b — VLM backbone with M-RoPE (vision frontend stubbed).

[arXiv:2409.12191]
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
The modality frontend is a STUB: ``input_specs()`` supplies precomputed patch
embeddings alongside M-RoPE (t, h, w) position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # t/h/w split of rotary half-dim (sums to 64)
    embeds_input=True,
)
