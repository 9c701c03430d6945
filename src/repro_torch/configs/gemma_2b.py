"""gemma-2b [arXiv:2403.08295; hf] — GeGLU, head_dim=256, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2_048, n_heads=8, n_kv_heads=1,
    d_ff=16_384, vocab_size=256_000, head_dim=256,
    gate_fn="gelu",
    microbatches=2,
)
