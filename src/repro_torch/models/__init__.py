"""repro_torch.models — the LM substrate's models (the dense transformer
family and RWKV-6 so far)."""
from repro_torch.models.registry import get_model

__all__ = ["get_model"]
