"""minitron-8b [dense]: pruned nemotron, GQA kv=8, 256k vocab.
[arXiv:2407.14679]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    rope_theta=10000.0, head_dim=128,
)

SMOKE = ArchConfig(
    name="minitron-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=1024,
    rope_theta=10000.0, head_dim=16,
)
