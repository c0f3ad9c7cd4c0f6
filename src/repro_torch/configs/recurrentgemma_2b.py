"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 2:1 pattern
(rec, rec, local-attn), MQA kv=1, window 2048. [arXiv:2402.19427]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000,
    head_dim=256, rope_theta=10000.0,
    block_pattern=("rec", "rec", "local"), local_window=2048,
    lru_width=2560, conv_kernel=4,
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke", family="hybrid",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab_size=512,
    head_dim=16, rope_theta=10000.0,
    block_pattern=("rec", "rec", "local"), local_window=16,
    lru_width=64, conv_kernel=4,
)
