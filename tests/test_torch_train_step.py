"""The port's train step against ``repro.train.train_step.make_train_step``
on the CPU: the dense, MoE, VLM and encoder-decoder families at
``reduced()`` with one and two microbatches, two steps from the JAX initial
state (``convert.train_state_from_jax``) on the same SyntheticLM batches,
COMPUTE_DTYPE fp32 in both packages (the RWKV-6 and hybrid families are in
``test_torch_train.py``); the dense family in bf16, the model's dtype;
the master draw against the serving draw, remat against no remat, the
named remat policies refused; and, on a card, every parameter's gradient
present and the recurrent families refused at the backward.

Tolerance: ``repro_torch.testing.TRAIN_STEP_TOL`` (fp32: sums in another
order and bf16 moments a rounding apart, measured ≤ 1.8e-4 of a norm;
bf16: twice the JAX package's own distance between its bf16 and fp32
step).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

from _torch_parity import cuda, step_parity  # noqa: F401


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b",
                                  "internvl2-76b", "whisper-tiny"])
def test_train_step_matches_jax(arch, n_micro):
    step_parity(arch, n_micro, "fp32")


def test_train_step_bf16_matches_jax():
    """The dense family in the model's compute dtype (no router: a bf16
    near-tie would send a token to other experts in the two frameworks)."""
    step_parity("qwen3-8b", 1, "bf16")


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b", "whisper-tiny"])
def test_masters_are_the_serving_draw(arch):
    """One draw: the masters (fp32) cast by ``serving_view`` are the
    serving parameters drawn from the same seed, bit for bit."""
    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    serving = model.init_params(cfg, device="cpu", seed=3)
    with TL.masters():
        masters = model.init_params(cfg, device="cpu", seed=3)
    view = TL.serving_view(masters)
    for a, b in zip(TL.tree_leaves(view), TL.tree_leaves(serving)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(x.dtype == torch.float32 for x in TL.tree_leaves(masters))


def _grads(cfg, seed=0):
    opt = topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = tts.init_train_state(cfg, opt, seed, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(seed))
    params = state["params"]
    leaves = topt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits = get_model(cfg).forward(TL.serving_view(params), cfg, tokens)
    tts.lm_loss(logits, tokens, vocab_size=cfg.vocab_size).backward()
    return [p.grad for p in leaves]


def test_remat_gives_the_same_gradients():
    cfg = get_config("qwen3-8b").reduced()
    with_remat = _grads(dataclasses.replace(cfg, remat=True))
    without = _grads(dataclasses.replace(cfg, remat=False))
    assert all(torch.equal(a, b) for a, b in zip(with_remat, without))
    with pytest.raises(NotImplementedError, match="item 15"):
        _grads(dataclasses.replace(cfg, remat_policy="block_outs"))


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b",
                                  "internvl2-76b", "whisper-tiny"])
def test_every_parameter_has_a_gradient_on_card(cuda, arch):  # noqa: F811
    """On the card the attention's gradient comes from the hand-written
    backward: after a step every master has a non-zero gradient."""
    cfg = get_config(arch).reduced()
    opt = topt.OptConfig()
    state = tts.init_train_state(cfg, opt, 0, device=cuda)
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
        frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model), cuda)
    grads = []
    tts.make_train_step(cfg, opt)(state, data.batch(0), keep_grads=grads)
    assert grads and all(bool(torch.any(g != 0)) for g in grads)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_recurrent_families_train_on_card(cuda, arch):  # noqa: F811
    """On the card RWKV-6's and the hybrid's wkv6 gradients come from the
    hand-written backward: after a step every master has a non-zero
    gradient, and the backward launched."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    cfg = get_config(arch).reduced()
    opt = topt.OptConfig()
    state = tts.init_train_state(cfg, opt, 0, device=cuda)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2, d_model=cfg.d_model), cuda)
    ops.reset_launch_counts()
    grads = []
    tts.make_train_step(cfg, opt)(state, data.batch(0), keep_grads=grads)
    torch.cuda.synchronize()
    assert grads and all(bool(torch.any(g != 0)) for g in grads)
    assert ops.launch_counts["wkv6_bwd"] > 0
