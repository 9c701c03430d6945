"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12_288, n_heads=96, n_kv_heads=8,
    d_ff=28_672, vocab_size=32_768, head_dim=128,
    # train_4k on one card in 8 microbatches: the dry run's peak, computed
    # for an H100 80GB HBM3 (700 W) model, is 2,203.2 GiB
    # (launch/dryrun.py); activation_sharding serves the meshes of ROADMAP
    # item 15
    microbatches=8, activation_sharding="seq",
)
