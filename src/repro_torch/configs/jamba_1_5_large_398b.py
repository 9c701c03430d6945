"""jamba-1.5-large-398b [arXiv:2403.19887; hf] — Mamba+attention 1:7
interleave, MoE 16 experts top-2 (every other layer)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8_192, n_heads=64, n_kv_heads=8,
    d_ff=24_576, vocab_size=65_536, head_dim=128,
    n_experts=16, experts_per_token=2,
    attn_period=8, moe_period=2,
    microbatches=8, activation_sharding="seq",
)
