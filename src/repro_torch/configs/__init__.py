"""Architecture registry: ``get_config(arch)`` resolves here (counterpart of
``repro.configs``).

The port runs every LM architecture of the JAX registry: the dense
transformer family, its MoE members, RWKV-6, the VLM (the dense
transformer with prepended patch embeddings), the hybrid Mamba/attention/
MoE family and the encoder-decoder family.
"""
from repro_torch.configs import base

ARCH_IDS = [
    "deepseek-moe-16b", "olmoe-1b-7b", "mistral-large-123b", "qwen3-8b",
    "gemma-2b", "deepseek-coder-33b", "whisper-tiny", "rwkv6-1.6b",
    "internvl2-76b", "jamba-1.5-large-398b",
]

_DENSE = {
    "mistral-large-123b": "mistral_large_123b",
    "qwen3-8b": "qwen3_8b",
    "gemma-2b": "gemma_2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
}
_MOE = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}
_VLM = {"internvl2-76b": "internvl2_76b"}
_HYBRID = {"jamba-1.5-large-398b": "jamba_1_5_large_398b"}
_ENCDEC = {"whisper-tiny": "whisper_tiny"}
_MODULES = {**_DENSE, **_MOE, "rwkv6-1.6b": "rwkv6_1_6b", **_VLM,
            **_HYBRID, **_ENCDEC}
DENSE_ARCH_IDS = [a for a in ARCH_IDS if a in _DENSE]
MOE_ARCH_IDS = [a for a in ARCH_IDS if a in _MOE]
VLM_ARCH_IDS = [a for a in ARCH_IDS if a in _VLM]
HYBRID_ARCH_IDS = [a for a in ARCH_IDS if a in _HYBRID]
ENCDEC_ARCH_IDS = [a for a in ARCH_IDS if a in _ENCDEC]


def get_config(arch: str) -> base.ModelConfig:
    import importlib
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch]}").CONFIG
