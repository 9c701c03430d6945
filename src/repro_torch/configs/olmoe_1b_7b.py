"""olmoe-1b-7b [arXiv:2409.02060; hf] — 64 experts, top-8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50_304,
    n_experts=64, n_shared_experts=0, experts_per_token=8,
    qk_norm=True,
    microbatches=2,
)
