"""internvl2-76b [arXiv:2404.16821; unverified] — InternViT frontend STUB
(precomputed patch embeddings) + InternLM2-style backbone."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8_192, n_heads=64, n_kv_heads=8,
    d_ff=28_672, vocab_size=128_256, head_dim=128,
    frontend="vision", frontend_tokens=256,
    microbatches=8, activation_sharding="seq",
)
