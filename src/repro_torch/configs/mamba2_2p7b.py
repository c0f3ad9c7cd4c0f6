"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    attn_kind="none",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    conv_kernel=4, ssm_groups=1,
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=512,
    attn_kind="none",
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    conv_kernel=4, ssm_groups=1,
)
