"""Shared helpers of the parity tests between ``repro`` and ``repro_torch``.

Inputs are made with NumPy from a seed and handed to both packages; the
round plan of a JAX tree run is replayed from its threefry key chain.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import ArrayPlan


def make_inputs(M, n, m, d, seed, frac_valid=0.85):
    """(M, n, d) candidates, (m, d) eval rows, (M, n) availability."""
    r = np.random.default_rng(seed)
    X = r.standard_normal((M, n, d)).astype(np.float32)
    E = r.standard_normal((m, d)).astype(np.float32)
    mask = r.random((M, n)) < frac_valid
    return X, E, mask


def jax_tree_plan(seed: int, mu: int, machines_per_round) -> ArrayPlan:
    """The slot permutations ``repro.core.tree.tree_maximize`` draws: per
    round ``key, kpart, kalg = split(key, 3)`` and ``permutation(kpart,
    L·μ)``."""
    key = jax.random.PRNGKey(seed)
    perms = []
    for L in machines_per_round:
        key, kpart, _ = jax.random.split(key, 3)
        perms.append(np.asarray(jax.random.permutation(kpart, L * mu)))
    return ArrayPlan(perms)


@pytest.fixture
def cuda():
    """The card, or a skip with the reason (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (python3 chip_smoke.py drives them)")
    return torch.device("cuda")
