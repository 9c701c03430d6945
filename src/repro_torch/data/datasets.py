"""Deterministic synthetic analogs of the paper's datasets (§4.1).

The originals (CSN, Tiny Images, Parkinsons, Yahoo Webscope R6A) are not
redistributable/offline; these generators match (n, d) and the qualitative
structure (clustered point clouds with outliers) so the paper's *relative*
claims — error w.r.t. centralized greedy vs. capacity — are reproducible.
Absolute objective values differ by construction; see EXPERIMENTS.md.

The port's own copy of ``repro.data.datasets`` (NumPy only): the port
imports nothing of the JAX package, and the parity tests hold the two
copies to the same bytes.
"""
from __future__ import annotations

import numpy as np


def _clusters(rng, n, d, n_clusters, spread=0.25, outlier_frac=0.02):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    X = centers[assign] + spread * rng.standard_normal((n, d)).astype(np.float32)
    n_out = int(outlier_frac * n)
    X[:n_out] = 3.0 * rng.standard_normal((n_out, d)).astype(np.float32)
    return X


def parkinsons(n=5_800, d=22, seed=0):
    """Biomedical voice measurements analog; normalized rows (paper §4.1)."""
    X = _clusters(np.random.default_rng(seed), n, d, 12)
    X -= X.mean(0)
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
    return X


def webscope(n=100_000, d=6, seed=1):
    """Yahoo! R6A user-visit features analog (d=6)."""
    return _clusters(np.random.default_rng(seed), n, d, 30, spread=0.4)


def csn(n=20_000, d=17, seed=2):
    """Community Seismic Network accelerometer features analog."""
    return _clusters(np.random.default_rng(seed), n, d, 20, spread=0.3)


def tiny(n=10_000, d=3_072, seed=3, n_clusters=50):
    """Tiny Images analog; zero-mean unit-norm rows (paper §4.1)."""
    X = _clusters(np.random.default_rng(seed), n, d, n_clusters, spread=0.5)
    X -= X.mean(0)
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
    return X


def large_scale(n=200_000, d=64, seed=4):
    """Stand-in for the 1M Tiny / 45M Webscope large-scale runs, sized for
    this CPU container; capacity ratios (0.05%, 0.1%) are preserved."""
    return _clusters(np.random.default_rng(seed), n, d, 100, spread=0.4)


REGISTRY = {
    "parkinsons": parkinsons,
    "webscope-100k": webscope,
    "csn-20k": csn,
    "tiny-10k": tiny,
    "large-scale": large_scale,
}
