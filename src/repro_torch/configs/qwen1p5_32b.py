"""qwen1.5-32b [dense]: MHA (kv=40) with QKV bias. [hf:Qwen/Qwen1.5-*]

With 40 KV heads of 128 the cache holds 2 x 40 x 128 values a token and
layer, 20,480 bytes in bf16: 32,768 tokens of 4 sequences over 64 layers
are 172 GB. The config's int8 cache stores them as int8 with a float32
scale a token and head (10,560 bytes); `kv_cache_dtype="int4"` halves
the payload again.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, head_dim=128,
    kv_cache_dtype="int8",
)

SMOKE = ArchConfig(
    name="qwen1.5-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=512,
    qkv_bias=True, rope_theta=1e6, head_dim=16,
    kv_cache_dtype="int8",
)
