"""mixtral-8x7b [moe]: 8 experts top-2, GQA kv=8, sliding-window attention.
[arXiv:2401.04088]

expert_sharding=tp: 8 experts < 16 model-axis chips, so experts replicate
and each expert's d_ff shards over `model` (DESIGN §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    num_experts=8, top_k=2, moe_d_ff=14336,
    expert_sharding="tp", sliding_window=4096,
    # 32 heads divide model=16 -> q is head-sharded (never ctx/seq-sharded),
    # so the banded SWA path is safe: O(S·(w+qb)) attention (§Perf it.8)
    banded_swa=True,
    rope_theta=1e6, head_dim=128,
)

SMOKE = ArchConfig(
    name="mixtral-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    num_experts=4, top_k=2, moe_d_ff=128,
    expert_sharding="tp", sliding_window=16,
    banded_swa=True,
    rope_theta=1e6, head_dim=16,
)
