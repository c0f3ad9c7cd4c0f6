"""llama3.2-3b [dense]: small llama3, GQA kv=8. [hf:meta-llama/Llama-3.2-*]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    rope_theta=500000.0, head_dim=128,
)

SMOKE = ArchConfig(
    name="llama3.2-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    rope_theta=500000.0, head_dim=16,
)
