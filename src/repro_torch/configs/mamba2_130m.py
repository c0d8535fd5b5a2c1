"""mamba2-130m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060]
24L d_model=768 (attn-free) vocab=50280, ssm_state=128
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    conv_width=4,
    ssd_chunk=256,
    tie_embeddings=True,   # mamba2-130m ties the LM head
)
