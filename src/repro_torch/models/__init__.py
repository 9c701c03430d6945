"""repro_torch.models — the LM substrate's models (the dense, MoE and VLM
transformer, RWKV-6, the hybrid and the encoder-decoder)."""
from repro_torch.models.registry import get_model

__all__ = ["get_model"]
