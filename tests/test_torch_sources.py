"""The port's ground-set sources and Feistel slots against the JAX package
on the CPU: the same seeded NumPy rows through ``repro.core.sources`` and
``repro_torch.core.sources`` give the same bytes (bf16 as bit patterns),
the same int8 block parameters and dequantized rows; every source kind
gathers what the array does; the Feistel permutation of the same round
keys is the same bijection, sliced or materialized."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import permute as jpermute
from repro.core import sources as jsrc
from repro.data import sources as jdsrc
from repro_torch.core import permute, sources
from repro_torch.core.sources import (ArraySource, ChunkedSource,
                                      QuantizedSource, SlicedSource)
from repro_torch.data.sources import ShardedSource, synthetic_sharded_source


def _rows(n=3000, d=6, seed=0):
    """Seeded rows with a constant stretch (whole int8 blocks of it at the
    smaller block sizes) and tie cases of the bf16 cast."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((n, d)) * 3.0).astype(np.float32)
    x[1000:1800] = np.float32(0.7)
    # exact midpoints between bf16 neighbours: round to even both ways
    x[5, :] = np.float32(1.0 + 2.0 ** -8)
    x[6, :] = np.float32(1.0 + 3 * 2.0 ** -8)
    return x


def _idx(n, size=500, seed=1):
    return np.random.default_rng(seed).integers(0, n, size)


def test_bf16_cast_matches_ml_dtypes_round_to_nearest_even():
    x = np.concatenate([np.random.default_rng(2).standard_normal(
        100_000).astype(np.float32), _rows().reshape(-1)])
    want = x.astype(jnp.bfloat16).view(np.uint16)
    got = sources.fp32_to_bf16(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sources.bf16_to_fp32(got),
                                  want.view(jnp.bfloat16).astype(np.float32))
    # the cast rounds: plain truncation keeps the upper 16 bits
    trunc = (x.view(np.uint32) >> 16).astype(np.uint16)
    assert np.mean(got == trunc) < 0.9


@pytest.mark.parametrize("store", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("q_block_rows", [64, 700, 4096])
def test_quantized_source_matches_jax(store, q_block_rows):
    x = _rows()
    jq = jsrc.QuantizedSource(jsrc.ArraySource(x), store, q_block_rows)
    tq = QuantizedSource(ArraySource(x), store, q_block_rows)
    idx = _idx(len(x))
    jrows, trows = np.asarray(jq.gather(idx)), tq.gather(idx)
    if store == "bf16":
        jrows = jrows.view(np.uint16)
    np.testing.assert_array_equal(trows, jrows)
    assert trows.dtype == jrows.dtype
    np.testing.assert_array_equal(tq.gather_qmeta(idx), jq.gather_qmeta(idx))
    np.testing.assert_array_equal(tq.dequantized(), jq.dequantized())
    assert tq.qcols == jq.qcols
    if store == "int8":
        np.testing.assert_array_equal(tq._scale, jq._scale)
        np.testing.assert_array_equal(tq._zp, jq._zp)
        # scales are powers of two; the constant block has q = 0
        m, _ = np.frexp(tq._scale)
        assert np.all(m == 0.5)
        B = q_block_rows
        const = np.arange(-(-1000 // B) * B, 1800 // B * B)
        np.testing.assert_array_equal(tq.gather(const), 0)
    chunks = [r for _, r in tq.iter_chunks(1000)]
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  tq.gather(np.arange(len(x))))
    np.testing.assert_array_equal(
        QuantizedSource.dequantize(trows, tq.gather_qmeta(idx)),
        tq.dequantized()[idx])
    np.testing.assert_array_equal(tq.gather_fp32(idx), x[idx])


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "bfloat16", "int8",
                                   np.float32, np.int8, np.float16])
def test_dtype_itemsize_matches_jax(dtype):
    assert sources.dtype_itemsize(dtype) == jsrc.dtype_itemsize(dtype)
    if isinstance(dtype, str) and dtype in sources.STORAGE_DTYPES:
        assert (sources.dtype_itemsize(sources.storage_np_dtype(dtype))
                == jsrc.dtype_itemsize(jsrc.storage_np_dtype(dtype)))
    assert sources.dtype_itemsize(torch.bfloat16) == 2


def _attrs(n, seed=3):
    r = np.random.default_rng(seed)
    return np.stack([r.uniform(0.2, 1.0, n), r.integers(0, 4, n)],
                    axis=1).astype(np.float32)


@pytest.mark.parametrize("kind", ["chunked", "sharded", "sliced",
                                  "sharded-quantized"])
def test_source_kinds_gather_as_the_array(kind):
    x, a = _rows(n=2000), _attrs(2000)
    ref = ArraySource(x, attrs=a)
    idx = _idx(2000, 400, seed=4)
    if kind == "chunked":
        src = ChunkedSource.from_array(x, 333, attrs=a)
    elif kind.startswith("sharded"):
        src = ShardedSource.from_arrays(
            [x[s:s + 450] for s in range(0, 2000, 450)],
            attrs=[a[s:s + 450] for s in range(0, 2000, 450)])
    else:
        src = SlicedSource(ref, 300, 1700)
        idx = np.clip(idx, 300, 1699)
    if kind.endswith("quantized"):
        src, ref = (QuantizedSource(src, "int8", 256),
                    QuantizedSource(ref, "int8", 256))
        np.testing.assert_array_equal(src.gather_qmeta(idx),
                                      ref.gather_qmeta(idx))
    np.testing.assert_array_equal(src.gather(idx), ref.gather(idx))
    rows, at = src.gather_with_attrs(idx)
    np.testing.assert_array_equal(rows, ref.gather(idx))
    np.testing.assert_array_equal(at, ref.gather_attrs(idx))
    np.testing.assert_array_equal(src.gather_attrs(idx), a[idx])
    if kind == "sliced":
        with pytest.raises(ValueError, match="non-local"):
            src.gather(np.array([10]))
    else:
        np.testing.assert_array_equal(src.materialize(), ref.materialize())
        np.testing.assert_array_equal(src.materialize_attrs(), a)


def test_synthetic_shards_match_jax():
    src = synthetic_sharded_source(n=1300, d=5, shard_rows=300, seed=7)
    jsrc_ = jdsrc.synthetic_sharded_source(n=1300, d=5, shard_rows=300,
                                           seed=7)
    np.testing.assert_array_equal(src.materialize(), jsrc_.materialize())
    gen = (lambda r, rows: r.uniform(0.1, 1.0, (rows, 1)))
    a = synthetic_sharded_source(n=700, d=3, shard_rows=250, seed=1,
                                 attr_gen=gen, a=1)
    ja = jdsrc.synthetic_sharded_source(n=700, d=3, shard_rows=250, seed=1,
                                        attr_gen=gen, a=1)
    idx = _idx(700, 50)
    rows, attrs = a.gather_with_attrs(idx)
    jrows, jattrs = ja.gather_with_attrs(idx)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(attrs, jattrs)


def test_prefetch_chunks_keeps_order_and_raises_reader_errors():
    x = _rows(n=1000)
    src = ChunkedSource.from_array(x, 64)
    got = list(sources.prefetch_chunks(src, depth=3))
    assert [s for s, _ in got] == list(range(0, 1000, 64))
    np.testing.assert_array_equal(np.concatenate([r for _, r in got]), x)

    def broken():
        yield x[:10]
        raise OSError("read failed")

    with pytest.raises(OSError, match="read failed"):
        list(sources.prefetch_chunks(ChunkedSource(broken, 1000, 6)))
    with pytest.raises(ValueError, match="depth"):
        next(sources.prefetch_chunks(src, depth=0))


def _jax_keys(seed):
    """The round keys ``repro.core.permute.FeistelPermutation.from_key``
    draws from a key."""
    return [int(v) for v in np.asarray(jax.random.randint(
        jax.random.PRNGKey(seed), (4,), 0, np.iinfo(np.int32).max,
        dtype=np.int32))]


@pytest.mark.parametrize("n", [1, 2, 5, 100, 4097, 30_000])
def test_feistel_matches_jax_and_is_a_bijection(n):
    jperm = jpermute.FeistelPermutation.from_key(jax.random.PRNGKey(n), n)
    perm = permute.FeistelPermutation.from_keys(_jax_keys(n), n)
    assert perm.round_keys == jperm.round_keys
    assert perm.half_bits == jperm.half_bits
    full = perm.materialize()
    np.testing.assert_array_equal(full, jperm.materialize())
    np.testing.assert_array_equal(np.sort(full), np.arange(n))
    idx = np.random.default_rng(n).integers(0, n, (7, 3))
    np.testing.assert_array_equal(perm(idx), full[idx])
    with pytest.raises(ValueError, match="domain"):
        perm(np.array([n]))


def test_feistel_slot_items_slices_match_materialized():
    L, mu, n_items = 9, 40, 333
    perm = permute.FeistelPermutation.from_keys(_jax_keys(3), L * mu)
    jperm = jpermute.FeistelPermutation.from_key(jax.random.PRNGKey(3),
                                                 L * mu)
    slots = np.arange(L * mu).reshape(L, mu)
    full = permute.feistel_slot_items(perm, n_items, slots)
    np.testing.assert_array_equal(
        full, jpermute.feistel_slot_items(jperm, n_items, slots))
    for w0, w1 in ((0, 1), (2, 5), (5, 9)):
        np.testing.assert_array_equal(
            permute.feistel_slot_items(perm, n_items, slots[w0:w1]),
            full[w0:w1])
    live = full[full >= 0]
    np.testing.assert_array_equal(np.sort(live), np.arange(n_items))
