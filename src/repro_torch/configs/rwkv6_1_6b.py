"""rwkv6-1.6b [arXiv:2404.05892; unverified] — Finch, attention-free,
data-dependent decay."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2_048, n_heads=32, n_kv_heads=32,
    d_ff=7_168, vocab_size=65_536, rwkv_head_dim=64,
    microbatches=2,
)
