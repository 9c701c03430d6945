"""Architecture registry: ``get_config(arch)`` resolves here (counterpart of
``repro.configs``).

The port runs the dense transformer family and RWKV-6; the other
architectures of the JAX registry are known here by name, and asking for
one raises :class:`NotImplementedError` (not ``KeyError``, which stays for
an arch that is not in the registry at all).
"""
from repro_torch.configs import base

ARCH_IDS = [
    "deepseek-moe-16b", "olmoe-1b-7b", "mistral-large-123b", "qwen3-8b",
    "gemma-2b", "deepseek-coder-33b", "whisper-tiny", "rwkv6-1.6b",
    "internvl2-76b", "jamba-1.5-large-398b",
]

#: the architectures the port runs: the dense family, then RWKV-6
_DENSE = {
    "mistral-large-123b": "mistral_large_123b",
    "qwen3-8b": "qwen3_8b",
    "gemma-2b": "gemma_2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
}
_MODULES = {**_DENSE, "rwkv6-1.6b": "rwkv6_1_6b"}
DENSE_ARCH_IDS = [a for a in ARCH_IDS if a in _DENSE]
PORTED_ARCH_IDS = [a for a in ARCH_IDS if a in _MODULES]


def get_config(arch: str) -> base.ModelConfig:
    import importlib
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: ROADMAP queue 1 item 14 (the "
            f"LM substrate; ported: {PORTED_ARCH_IDS})")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch]}").CONFIG
