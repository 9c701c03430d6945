"""qwen3-8b [hf:Qwen/Qwen3-8B; hf] — qk_norm, GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4_096, n_heads=32, n_kv_heads=8,
    d_ff=12_288, vocab_size=151_936, head_dim=128,
    qk_norm=True,
    microbatches=8,   # §Perf: 29.3→8.7 GiB/dev
)
