"""internvl2-26b [vlm]: InternViT frontend stubbed (input_specs provides
precomputed patch embeddings (B, 256, 6144)); InternLM2-20B-style backbone.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    rope_theta=1e6, head_dim=128,
    patch_tokens=256,
)

SMOKE = ArchConfig(
    name="internvl2-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    rope_theta=1e6, head_dim=16,
    patch_tokens=8,
)
