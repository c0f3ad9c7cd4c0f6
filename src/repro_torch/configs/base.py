"""ArchConfig: one dataclass describes every architecture of the LM zoo
(port of `repro/configs/base.py`).

Each ported architecture has a module `repro_torch/configs/<id>.py`
exporting CONFIG (the exact published shape) and SMOKE (a reduced
same-family shape for CPU tests). The dataclass is the JAX package's,
field for field, so a config of either package describes the same model;
`registry()` maps the port's ids to their configs and `--arch <id>`
resolves here.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # attention
    attn_kind: str = "gqa"          # gqa | mla | none
    qkv_bias: bool = False
    sliding_window: int = 0         # mixtral SWA
    rope_theta: float = 10000.0

    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    expert_sharding: str = "ep"     # ep (experts over model) | tp (d_ff over model)
    capacity_factor: float = 1.25
    moe_dispatch: str = "sorted"    # sorted (scatter, O(T·k·D)) | einsum
                                    # (one-hot reference, O(T·E·C)) — §Perf it.3

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    ssm_groups: int = 1

    # hybrid (recurrentgemma): pattern repeats (rec, rec, local-attn)
    block_pattern: tuple = ()
    local_window: int = 2048
    lru_width: int = 0

    # enc-dec (whisper: conv frontend stubbed as precomputed frames)
    encoder_layers: int = 0
    encoder_frames: int = 0
    cross_attention: bool = False
    max_positions: int = 0          # learned positional embedding (whisper)

    # vlm (internvl2: ViT frontend stubbed as precomputed patch embeddings)
    patch_tokens: int = 0

    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    attn_chunk: int = 512           # streaming-softmax KV chunk
    inner_remat: bool = True        # checkpoint attention/SSD chunk bodies
                                    # (flash-style bwd recompute; §Perf it.1)
    banded_swa: bool = False        # sliding-window attention touches only
                                    # its band: O(S·(w+qb)) not O(S²); safe
                                    # when heads divide `model` (§Perf it.8)

    # serving
    kv_cache_dtype: str = "bf16"    # bf16 | int8 | int4 (quantised cache)
    kv_shard: str = "heads"         # heads | seq (context-parallel cache)

    # sub-quadratic? (controls long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab axis always
        shards over `model` (=16) and logits hit MXU-aligned tiles (×128).
        Standard TPU practice (MaxText does the same); the pad logits are
        masked to -inf in the loss. Structural change noted in DESIGN §9."""
        return -(-self.vocab_size // 256) * 256

    def param_count(self) -> float:
        """Approximate parameter count (embedding + layers), for 6ND math."""
        d = self.d_model
        n = 0.0
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim
        for li in range(self.num_layers):
            kind = self.layer_kind(li)
            if kind in ("attn", "local"):
                n += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                n += self.num_heads * hd * d
            elif kind == "mla":
                n += d * (self.kv_lora_rank + self.qk_rope_dim)
                n += self.kv_lora_rank * self.num_heads * (
                    self.qk_nope_dim + self.v_head_dim)
                n += d * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                n += self.num_heads * self.v_head_dim * d
            elif kind == "rec":
                w = self.lru_width or d
                n += 2 * d * w + w * d + 2 * w * (self.conv_kernel + 2)
            elif kind == "ssd":
                di = self.ssm_expand * d
                n += d * (2 * di + 2 * self.ssm_groups * self.ssm_state) + di * d
            # ffn
            if kind in ("attn", "local", "mla", "rec"):
                if self.num_experts and li >= self.first_dense_layers \
                        and kind != "rec":
                    per = 3 * d * self.moe_d_ff
                    n += self.num_experts * per + self.num_shared_experts * per
                    n += d * self.num_experts
                else:
                    mult = 3 if self.act == "swiglu" else 2
                    n += mult * d * self.d_ff
        if self.encoder_layers:
            n += self.encoder_layers * (4 * d * d + 2 * d * self.d_ff)
        return n

    def active_param_count(self) -> float:
        """MoE: params touched per token (for 6·N_active·D)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        moe_layers = self.num_layers - self.first_dense_layers
        per = 3 * d * self.moe_d_ff
        inactive = moe_layers * (self.num_experts - self.top_k) * per
        return total - inactive

    def layer_kind(self, li: int) -> str:
        if self.family == "ssm":
            return "ssd"
        if self.block_pattern:
            return self.block_pattern[li % len(self.block_pattern)]
        if self.attn_kind == "mla":
            return "mla"
        if self.sliding_window:
            return "local"
        return "attn"


# The zoo, in the JAX package's order: the dense full-attention models
# (Qwen 1.5 with its int8 KV cache), the MoE family (Mixtral with
# sliding-window attention, DeepSeek-V2-Lite with MLA), Mamba 2 (SSD), the
# RecurrentGemma hybrid (RG-LRU with local MQA), Whisper (encoder-decoder:
# an encoder over audio frames, cross attention, learned positions) and
# InternVL2 (patch rows ahead of the prompt).
ARCH_IDS = [
    "whisper_tiny", "mamba2_2p7b", "qwen2p5_14b", "llama3p2_3b",
    "minitron_8b", "qwen1p5_32b", "internvl2_26b", "recurrentgemma_2b",
    "deepseek_v2_lite_16b", "mixtral_8x7b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    arch = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG


def registry() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# Assigned input shapes (per-arch applicability filtered in shapes_for)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ArchConfig) -> list:
    """long_500k only for sub-quadratic archs (skip noted in DESIGN §5)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out
