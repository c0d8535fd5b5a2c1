"""seamless-m4t-large-v2 — encoder-decoder multimodal (audio frontend stubbed).

[arXiv:2308.11596]
24L (enc) + 24L (dec) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206
``input_specs()`` supplies precomputed speech-frame embeddings for the encoder;
the text decoder consumes token ids with cross-attention into the encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,            # per stack; see encoder_layers/decoder_layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    qkv_bias=True,
    rope_theta=10_000.0,
    encoder_layers=24,
    decoder_layers=24,
    embeds_input=True,        # encoder input is precomputed frame embeddings
)
