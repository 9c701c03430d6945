"""deepseek-coder-33b [arXiv:2401.14196; hf] — llama-arch dense."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7_168, n_heads=56, n_kv_heads=8,
    d_ff=19_200, vocab_size=32_256, head_dim=128,
    microbatches=4, activation_sharding="seq",
)
