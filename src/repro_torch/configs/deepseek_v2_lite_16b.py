"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + MoE 64 routed top-6 with
2 shared experts; first layer dense. [arXiv:2405.04434]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    attn_kind="mla", kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    num_experts=64, num_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1, expert_sharding="ep",
    # EP mode keeps the one-hot einsum dispatch: GSPMD lowers it to the
    # expert all-to-all, whereas the sorted scatter against an
    # expert-sharded buffer gathers its updates (+111% collective bytes
    # measured — EXPERIMENTS §Perf it.3 note). tp-mode archs (mixtral)
    # default to "sorted".
    moe_dispatch="einsum",
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="deepseek-v2-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    attn_kind="mla", kv_lora_rank=32,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    num_experts=8, num_shared_experts=1, top_k=2, moe_d_ff=32,
    first_dense_layers=1, expert_sharding="ep",
    rope_theta=10000.0,
)
