"""The port's ``rbf_kernel`` against the JAX package on the CPU: its plain
version against ``repro.kernels.ref.rbf_kernel`` and against the Pallas
kernel in interpret mode, at ragged shapes and with a machine axis on
either operand; the rule that picks the kernel's instantiation; and the
CUDA kernel against its plain version on a card, in both instantiations
(the row vector for n ≤ 4, the 32 × 128 tile above), at ragged m around
the row vector's 1,024-row span.

Tolerance: ``repro_torch.testing`` (rtol = atol = 1e-5); K(x, x) is 1 to
the bit in the plain version, whose norms and dot products share one order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rbf_kernel as rbf_mod

from _torch_parity import cuda  # noqa: F401

SHAPES = [(1, 1, 1), (7, 13, 1), (33, 65, 6), (40, 129, 22), (31, 300, 64)]


def _rows(seed, shape):
    """Rows at a scale where K spans (0, 1): ‖x − y‖² ≈ 2 on average."""
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)


@pytest.mark.parametrize("h", [0.5, 1.0])
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_rbf_plain_matches_jax_ref(n, m, d, h):
    X, Y = _rows(n, (n, d)), _rows(m + 1, (m, d))
    got = ops.rbf_kernel(torch.from_numpy(X), torch.from_numpy(Y), h)
    assert got.shape == (n, m)
    testing.assert_close(got, jref.rbf_kernel(jnp.asarray(X), jnp.asarray(Y),
                                              h))
    assert bool(torch.all((got >= 0) & (got <= 1)))
    Kxx = ops.rbf_kernel(torch.from_numpy(X), torch.from_numpy(X), h)
    assert bool(torch.all(torch.diagonal(Kxx) == 1.0))


@pytest.mark.parametrize("n,m,d,h", [(16, 16, 8, 0.5), (33, 65, 7, 1.0),
                                     (40, 129, 22, 0.5)])
def test_rbf_plain_matches_pallas_interpret(n, m, d, h):
    X, Y = _rows(d, (n, d)), _rows(d + 1, (m, d))
    want = jops.rbf_kernel(jnp.asarray(X), jnp.asarray(Y), h, impl="pallas",
                           bn=16, bm=16)
    testing.assert_close(ops.rbf_kernel(torch.from_numpy(X),
                                        torch.from_numpy(Y), h), want)


@pytest.mark.parametrize("axis", ["X", "Y", "both"])
def test_rbf_machine_axis(axis):
    """A machine axis on either operand or both: machine i of the result is
    the JAX kernel matrix of machine i's operands (a shared operand is the
    same for every machine)."""
    M, n, m, d, h = 3, 21, 70, 6, 0.5
    X = _rows(1, (M, n, d) if axis != "Y" else (n, d))
    Y = _rows(2, (M, m, d) if axis != "X" else (m, d))
    got = ops.rbf_kernel(torch.from_numpy(X), torch.from_numpy(Y), h)
    assert got.shape == (M, n, m)
    for i in range(M):
        xi = X[i] if X.ndim == 3 else X
        yi = Y[i] if Y.ndim == 3 else Y
        testing.assert_close(got[i], jref.rbf_kernel(jnp.asarray(xi),
                                                     jnp.asarray(yi), h),
                             f"machine {i}")


def test_rbf_chunks_give_the_same_bits(monkeypatch):
    """Machine chunks and row chunks of the plain version change no bit."""
    M, n, m, d, h = 5, 37, 50, 6, 0.5
    X, Y = torch.from_numpy(_rows(3, (M, n, d))), torch.from_numpy(
        _rows(4, (M, m, d)))
    whole = ref.rbf_kernel(X, Y, h)
    for elems in (2 * n * m, n * m // 3):      # 2 machines, then 15 rows
        monkeypatch.setattr(ref, "_CHUNK_ELEMS", elems)
        assert torch.equal(ref.rbf_kernel(X, Y, h), whole)
        assert torch.equal(ref.rbf_kernel(X[0], Y, h), ref.rbf_kernel(
            X[0].expand(M, n, d), Y, h))


def test_rbf_dispatch_refuses_other_devices():
    X = torch.zeros((2, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for tensors on meta"):
        ops.rbf_kernel(X, X, 0.5)
    with pytest.raises(ValueError, match="do not pair up"):
        ref.rbf_kernel(torch.zeros((2, 4, 3)), torch.zeros((3, 5, 3)), 0.5)


@pytest.mark.parametrize("n,d,vec", [(1, 6, True), (4, 32, True),
                                     (5, 6, False), (1, 33, False),
                                     (512, 6, False)])
def test_rbf_instantiation_rule(n, d, vec):
    """The row vector takes a few X rows of few features; the tile the rest
    (FacilityLocation's 512 eval rows among them)."""
    assert rbf_mod.rowvec(n, d) is vec


@pytest.mark.parametrize("n,m,d", [(1, 22_500, 6), (512, 977, 6),
                                   (33, 301, 22), (70, 129, 64),
                                   (1, 1023, 6), (2, 1024, 6), (3, 1025, 22),
                                   (4, 2049, 32), (5, 1025, 6), (1, 3, 33)])
def test_rbf_kernel_matches_plain_on_card(cuda, n, m, d):  # noqa: F811
    M = 4
    X = torch.as_tensor(_rows(n, (n, d)), device=cuda)
    Y = torch.as_tensor(_rows(m, (M, m, d)), device=cuda)
    for h in (0.5, 1.0):
        ops.reset_launch_counts()
        got = ops.rbf_kernel(X, Y, h)
        assert ops.launch_counts["rbf_kernel_rowvec"] == int(
            rbf_mod.rowvec(n, d))
        testing.assert_close(got, ref.rbf_kernel(X, Y, h))
        Kxx = ops.rbf_kernel(Y, Y, h)
        assert bool(torch.all(torch.diagonal(Kxx, dim1=-2, dim2=-1) == 1.0))
        # K(x, x) = 1 in the row vector too: X rows taken from each machine
        i = min(n, m)
        Kxy = ops.rbf_kernel(Y[:, :i], Y, h)
        assert bool(torch.all(torch.diagonal(Kxy, dim1=-2, dim2=-1) == 1.0))
