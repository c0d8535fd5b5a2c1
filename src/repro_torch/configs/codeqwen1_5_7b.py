"""codeqwen1.5-7b — dense MHA (GQA kv=32 == heads) decoder-only LM.

[hf:Qwen/CodeQwen1.5-7B]
32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,          # qwen1.5 arch keeps QKV bias
    rope_theta=1_000_000.0,
)
