"""repro_torch.core.compressor against repro.core.compressor (CPU).

Tolerances: keys, indices, residuals and picked values are exact (no
arithmetic but one add and a selection).  ``decompress_sum`` adds
duplicate keys: exact here too, since both sides add in index order on
the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressor as jcomp
from repro_torch import convert
from repro_torch.core import compressor


def _t(x):
    return convert.tensor(x, device="cpu")


def _grad(seed, shape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape).astype(np.float32),
            (r.standard_normal(shape) * 0.5).astype(np.float32))


def _assert_pair_same(jout, tout):
    (jc, js), (tc, ts) = jout, tout
    np.testing.assert_array_equal(tc.keys.numpy(), np.asarray(jc.keys))
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    assert tc.shape == jc.shape and tc.keys.dtype == torch.int32
    np.testing.assert_array_equal(ts.residual.numpy(),
                                  np.asarray(js.residual))


def test_init_state_matches_jax():
    st = compressor.init_state((4, 6), device="cpu")
    assert st.residual.shape == (4, 6) and st.residual.dtype == torch.float32
    assert not bool(st.residual.any())
    np.testing.assert_array_equal(st.residual.numpy(),
                                  np.asarray(jcomp.init_state((4, 6)).residual))


@pytest.mark.parametrize("shape,k", [((64,), 5), ((16, 32), 17), ((8, 8), 64)])
def test_topk_compress_matches_jax(shape, k):
    g, res = _grad(k, shape)
    jout = jcomp.topk_compress(jnp.asarray(g), jcomp.CompressorState(
        jnp.asarray(res)), k=k)
    tout = compressor.topk_compress(_t(g), convert.compressor_state(
        jcomp.CompressorState(jnp.asarray(res)), device="cpu"), k=k)
    _assert_pair_same(jout, tout)


@pytest.mark.parametrize("shape,k,chunk", [((16, 64), 4, 64),
                                           ((4, 128), 9, 256),
                                           ((64, 512), 5, 512)])
def test_blockwise_topk_compress_matches_jax(shape, k, chunk):
    g, res = _grad(chunk, shape)
    jout = jcomp.blockwise_topk_compress(
        jnp.asarray(g), jcomp.CompressorState(jnp.asarray(res)), k=k,
        chunk=chunk)
    tout = compressor.blockwise_topk_compress(
        _t(g), compressor.CompressorState(_t(res)), k=k, chunk=chunk)
    _assert_pair_same(jout, tout)


def test_ties_go_to_the_lower_index_like_jax_top_k():
    g = np.zeros((2, 16), np.float32)
    g[0, [3, 7, 11]] = 1.0
    g[0, 5] = -1.0
    g[1, [0, 15]] = -2.0
    zero = np.zeros_like(g)
    jout = jcomp.blockwise_topk_compress(
        jnp.asarray(g), jcomp.CompressorState(jnp.asarray(zero)), k=5,
        chunk=16)
    tout = compressor.blockwise_topk_compress(
        _t(g), compressor.CompressorState(_t(zero)), k=5, chunk=16)
    _assert_pair_same(jout, tout)
    assert tout[0].keys[:5].tolist() == [3, 5, 7, 11, 0]
    jflat = jcomp.topk_compress(jnp.asarray(g), jcomp.CompressorState(
        jnp.asarray(zero)), k=6)
    tflat = compressor.topk_compress(_t(g), compressor.CompressorState(
        _t(zero)), k=6)
    _assert_pair_same(jflat, tflat)


def test_blockwise_chunk_must_divide():
    with pytest.raises(ValueError, match="not divisible by chunk 7"):
        compressor.blockwise_topk_compress(
            torch.zeros(20), compressor.CompressorState(torch.zeros(20)),
            k=2, chunk=7)


def test_decompress_sum_drops_empty_and_adds_duplicates():
    r = np.random.default_rng(0)
    keys = r.integers(-3, 40, 200).astype(np.int32)  # negatives: dropped
    vals = r.standard_normal(200).astype(np.float32)
    want = jcomp.decompress_sum(jnp.asarray(keys), jnp.asarray(vals),
                                size=40)
    got = compressor.decompress_sum(_t(keys), _t(vals), size=40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (40,)


def test_compression_ratio_matches_jax():
    for shape, k in (((8192, 3072), 251904), ((10,), 1), ((4, 4), 16)):
        assert compressor.compression_ratio(shape, k) == \
            jcomp.compression_ratio(shape, k)
        assert compressor.compression_ratio(shape, k, 8, 2, 2) == \
            jcomp.compression_ratio(shape, k, 8, 2, 2)
