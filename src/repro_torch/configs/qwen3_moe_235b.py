"""qwen3-moe-235b-a22b — 128-expert top-8 MoE decoder-only LM.

[hf:Qwen/Qwen3-30B-A3B family; 235B-A22B scale point]
94L d_model=4096 64H (GQA kv=4) d_ff=1536/expert vocab=151936, MoE 128e top-8
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qkv_bias=False,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_token=8,
    capacity_factor=1.25,
)
