"""Model/config schema of the LM substrate (the port's own copy of
``repro.configs.base``, so nothing of ``repro`` is imported).

One `ModelConfig` per architecture (exact literature values in the sibling
modules) plus `reduced()` for CPU smoke tests and the shape grid of the
assigned cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # default d_model // n_heads
    qk_norm: bool = False
    gate_fn: str = "silu"               # silu (SwiGLU) | gelu (GeGLU)
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_impl: str = "onehot"            # onehot (GShard masks) | sort
    moe_group_size: int = 512           # tokens per dispatch group
    # --- hybrid (jamba): one attention layer per `attn_period` layers ---
    attn_period: int = 0
    moe_period: int = 0                 # MoE MLP every `moe_period` layers
    # --- rwkv / mamba ---
    rwkv_head_dim: int = 64
    ssm_state_dim: int = 16             # mamba d_state (jamba uses Mamba-1's 16)
    ssm_expand: int = 2                 # d_inner = expand * d_model
    # --- enc-dec ---
    encoder_layers: int = 0
    # --- modality frontend stub: "audio" | "vision" | None ---
    frontend: Optional[str] = None
    frontend_tokens: int = 256          # vlm: image patch embeddings prepended
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # --- training substrate knobs ---
    microbatches: int = 1               # grad-accumulation steps per train step
    remat: bool = True
    remat_policy: str = "full"          # full | block_outs (§Perf: save the
                                        # post-collective block outputs so the
                                        # backward re-run skips fwd TP ARs)
    activation_sharding: str = "replicated"  # residual placement between
                                        # blocks (§Perf): replicated | seq
                                        # (Megatron-SP: S over 'model') |
                                        # hidden (d over 'model')
    moment_dtype: str = "bfloat16"      # AdamW m/v dtype (memory/quality knob)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else (
            self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so logits/emb shard over any mesh axis
        (whisper's 51865 would otherwise replicate 13.6 GB of logits)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, Hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        dense_mlp = 3 * d * ff
        emb = V * d * 2  # in + out (untied)
        if self.family == "ssm":   # rwkv6
            L = self.n_layers
            d_att = self.n_heads * self.rwkv_head_dim
            tmix = d * d_att * 4 + d_att * d + d * d + d * 64 + 64 * d_att
            cmix = d * ff + ff * d
            return emb + L * (tmix + cmix)
        if self.family == "hybrid":
            L = self.n_layers
            n_attn = L // self.attn_period
            n_mamba = L - n_attn
            n_moe = L // self.moe_period if self.moe_period else 0
            n_dense = L - n_moe
            d_in = 2 * d
            mamba = d * d_in * 2 + d_in * d + d_in * 3 * self.hd
            moe = self.n_experts * 3 * d * ff
            return (emb + n_attn * attn + n_mamba * mamba
                    + n_moe * moe + n_dense * dense_mlp)
        if self.is_moe:
            moe = (self.n_experts + self.n_shared_experts) * 3 * d * ff \
                + d * self.n_experts
            return emb + self.n_layers * (attn + moe)
        L = self.n_layers + self.encoder_layers
        cross = self.encoder_layers and attn or 0
        return emb + L * (attn + dense_mlp) + self.n_layers * cross

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        total_moe_layers = (self.n_layers if self.family == "moe"
                            else (self.n_layers // self.moe_period
                                  if self.moe_period else 0))
        unused = (self.n_experts - self.experts_per_token) * 3 * d * ff
        return self.param_count() - total_moe_layers * unused

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else
                         max(2 * (self.attn_period or 2), 4)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab_size=512,
            head_dim=16 if self.head_dim else None,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            experts_per_token=min(self.experts_per_token, 2),
            # no-drop capacity so decode == forward in equivalence tests
            # (dropping MoE legitimately differs across batch shapes)
            moe_capacity_factor=4.0,
            encoder_layers=min(self.encoder_layers, 2),
            attn_period=min(self.attn_period, 4) if self.attn_period else 0,
            moe_period=min(self.moe_period, 2) if self.moe_period else 0,
            rwkv_head_dim=16,
            frontend_tokens=8 if self.frontend else 0,
            microbatches=1,
        )


# ---------------------------------------------------------------------------
# Assigned input shapes (per architecture; see system assignment)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only SSM/hybrid archs run it
# (DESIGN.md §5); encoder-only archs would skip decode shapes (none assigned).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cells_for(cfg: ModelConfig) -> list[str]:
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
            continue  # skip recorded in DESIGN.md §5
        out.append(s.name)
    return out
