"""recurrentgemma-9b — hybrid RG-LRU + local attention (pattern rec,rec,attn).

[arXiv:2402.19427]
38L d_model=4096 16H (GQA kv=1 == MQA) d_ff=12288 vocab=256000
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    qkv_bias=False,
    rope_theta=10_000.0,
    lru_width=4096,
    local_window=2048,
    conv_width=4,
    block_pattern=("rec", "rec", "attn"),
)
