"""whisper-tiny [audio]: enc-dec, conv frontend stubbed (input_specs provides
precomputed (B, 1500, 384) frame embeddings). [arXiv:2212.04356]

Structural note (DESIGN §9): learned positions extended to 32768 so the
assigned train_4k/prefill_32k/decode_32k shapes lower (the published
448-position table is a trained-weights property, not a structural one).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    norm="layernorm", act="gelu", qkv_bias=True,
    rope_theta=0.0, max_positions=32768,
    encoder_layers=4, encoder_frames=1500, cross_attention=True,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="whisper-tiny-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    norm="layernorm", act="gelu", qkv_bias=True,
    rope_theta=0.0, max_positions=128,
    encoder_layers=2, encoder_frames=24, cross_attention=True,
    tie_embeddings=True,
)
