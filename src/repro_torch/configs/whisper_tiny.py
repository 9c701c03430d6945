"""whisper-tiny [arXiv:2212.04356; unverified] — enc-dec, conv frontend STUB
(input_specs provides precomputed frame embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1_536, vocab_size=51_865,
    encoder_layers=4, frontend="audio",
)
