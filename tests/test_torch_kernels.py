"""repro_torch.kernels on CPU tensors against the JAX package.

On a CPU tensor every kernel wrapper takes its plain torch version, so
these tests hold the wrappers' contracts (shapes, padding, the fast-mode
pre-combine, error feedback, launch counting) against the JAX package's
jnp oracles.  The Pallas calls themselves are not used: they do not run
on the installed jax.  The kernels run on the card in ``chip_smoke.py``
and in ``tests/test_torch_on_card.py``.

Tolerances: keys, indices, counts and scan values are exact (same
sequential order).  The fast-mode table is exact (pre-combined sums add
in index order on both sides).  Grouped totals and the decompressed sums
of a cascade: rtol 1e-6, atol 1e-6, since the two sides group the same
f32 addends in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dict_aggregate
from repro.core import kvagg as jkvagg
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import kvagg
from repro_torch.kernels import kv_aggregate, ops, ref, topk_compress

EMPTY = -1


def _t(x):
    return convert.tensor(x, device="cpu")


def _stream(seed, n=300, variety=40):
    r = np.random.default_rng(seed)
    keys = r.integers(0, variety, n).astype(np.int32)
    keys[r.random(n) < 0.05] = EMPTY
    return keys, r.standard_normal(n).astype(np.float32)


def jax_compress_grad(grad, residual, *, k, chunk):
    """The JAX package's ``kernels.ops.compress_grad`` with the Pallas call
    replaced by its oracle ``ref.topk_ref``."""
    acc = jnp.asarray(grad).reshape(-1) + jnp.asarray(residual).reshape(-1)
    mat = acc.reshape(-1, chunk)
    vals, idx = jref.topk_ref(mat, k)
    rows = mat.shape[0]
    gkeys = (idx + jnp.arange(rows, dtype=jnp.int32)[:, None] * chunk
             ).reshape(-1)
    return gkeys, vals.reshape(-1), acc.at[gkeys].set(0.0).reshape(
        np.shape(residual))


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never launch a kernel."""
    kv_aggregate.launches = topk_compress.launches = 0
    yield
    assert kv_aggregate.launches == 0 and topk_compress.launches == 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("capacity,ways,bpe", [(1, 1, True), (16, 4, False),
                                               (64, 8, True)])
def test_two_level_aggregate_matches_jax(capacity, ways, bpe, seed):
    keys, vals = _stream(capacity + ways + 100 * seed)
    jr = jkvagg.two_level_aggregate(jnp.asarray(keys), jnp.asarray(vals),
                                    capacity=capacity, ways=ways, bpe=bpe)
    tr = ops.two_level_aggregate(_t(keys), _t(vals), capacity=capacity,
                                 ways=ways, bpe=bpe)
    for name in jr._fields:
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)


def test_two_level_aggregate_mean_lanes_match_jax():
    keys, raw = _stream(3)
    from repro.core import aggops as jaggops
    carried = np.asarray(jaggops.get("mean").prepare_values(jnp.asarray(raw)))
    jr = jkvagg.two_level_aggregate(jnp.asarray(keys), jnp.asarray(carried),
                                    capacity=16, ways=4, op="mean")
    tr = ops.two_level_aggregate(_t(keys), _t(carried), capacity=16, ways=4,
                                 op="mean")
    assert tr.out_values.shape[1:] == (2,)
    np.testing.assert_array_equal(tr.out_values.numpy(),
                                  np.asarray(jr.out_values))


def test_cuda_wrapper_fast_mode_keeps_the_pallas_contract():
    """exact_stream=False: pre-combine, then the scan over distinct keys;
    the stream stays [n] and the table equals kvagg's fast path's."""
    keys, vals = _stream(9)
    n = keys.shape[0]
    tk, tv, ek, ev = kv_aggregate.fpe_aggregate_cuda(
        _t(keys), _t(vals), capacity=16, ways=4, exact_stream=False)
    assert ek.shape == (n,) and tk.shape == (16,)
    jf = jkvagg.fpe_aggregate(jnp.asarray(keys), jnp.asarray(vals),
                              capacity=16, ways=4, exact_stream=False)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jf.table_keys))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jf.table_values))
    got = dict_aggregate(np.concatenate([tk.numpy(), ek.numpy()]),
                         np.concatenate([tv.numpy(), ev.numpy()]))
    want = dict_aggregate(keys, vals)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6)


def test_cuda_wrapper_exact_mode_is_the_scan():
    keys, vals = _stream(4)
    got = kv_aggregate.fpe_aggregate_cuda(_t(keys), _t(vals), capacity=8,
                                          ways=2)
    want = jref.fpe_aggregate_ref(jnp.asarray(keys), jnp.asarray(vals),
                                  capacity=8, ways=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    oracle = ref.fpe_aggregate_ref(_t(keys), _t(vals), capacity=8, ways=2)
    for g, w in zip(got, oracle):
        assert torch.equal(g, w)


def test_fpe_launch_refuses_cpu_tensors():
    keys, vals = _stream(1, n=8)
    with pytest.raises(ValueError, match="CUDA"):
        kv_aggregate._launch(_t(keys), _t(vals)[:, None], n_buckets=2,
                             ways=2, op="sum", table_keys=None,
                             table_values=None)
    with pytest.raises(ValueError, match="CPU"):
        kvagg._fpe_scan_plain(_t(keys).to("meta"), _t(vals)[:, None],
                              n_buckets=2, ways=2, op="sum")


@pytest.mark.parametrize("rows,cols,k", [(16, 256, 8), (4, 512, 16),
                                         (13, 100, 7), (8, 128, 128)])
def test_topk_matches_jax_ref(rows, cols, k):
    x = np.random.default_rng(rows * cols).standard_normal(
        (rows, cols)).astype(np.float32)
    jv, ji = jref.topk_ref(jnp.asarray(x), k)
    tv, ti = topk_compress.topk_rows(_t(x), k=k)
    assert ti.dtype == torch.int32 and tv.shape == (rows, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    rv, ri = ref.topk_ref(_t(x), k)
    assert torch.equal(rv, tv) and torch.equal(ri, ti)


def test_topk_ties_zeros_and_bf16_match_jax():
    x = np.zeros((4, 64), np.float32)
    x[1] = 1.0
    x[2, 5], x[2, 9], x[2, 30] = -2.0, 2.0, 2.0
    x[3] = np.random.default_rng(0).standard_normal(64)
    jv, ji = jref.topk_ref(jnp.asarray(x), 6)
    tv, ti = topk_compress.topk_rows(_t(x), k=6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[2, :3].tolist() == [5, 9, 30]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jv, ji = jref.topk_ref(xb, 6)
    tv, ti = topk_compress.topk_rows(_t(xb), k=6)
    assert tv.dtype == torch.bfloat16
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))


def test_topk_k_greater_than_cols_raises():
    with pytest.raises(ValueError, match="k=9 > cols=8"):
        topk_compress.topk_rows(torch.zeros((2, 8)), k=9)
    with pytest.raises(ValueError, match="rows, cols"):
        topk_compress.topk_rows(torch.zeros(8), k=2)


@pytest.mark.parametrize("shape,chunk,k", [((8, 64), 64, 4),
                                           ((16, 32), 128, 8)])
def test_compress_grad_matches_jax(shape, chunk, k):
    r = np.random.default_rng(chunk)
    grad = r.standard_normal(shape).astype(np.float32)
    residual = (r.standard_normal(shape) * 0.1).astype(np.float32)
    jk, jv, jres = jax_compress_grad(grad, residual, k=k, chunk=chunk)
    tk, tv, tres = ops.compress_grad(_t(grad), _t(residual), k=k,
                                     chunk=chunk)
    assert tk.dtype == torch.int32 and tres.shape == shape
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    # error feedback: the residual is zero exactly at the chosen keys
    assert bool((tres.reshape(-1)[tk.long()] == 0).all())


def test_compress_grad_chunk_must_divide():
    with pytest.raises(ValueError, match="not divisible by chunk 48"):
        ops.compress_grad(torch.zeros(100), torch.zeros(100), k=2, chunk=48)


def test_segment_and_combine_oracles_match_jax():
    r = np.random.default_rng(2)
    vals = r.standard_normal(64).astype(np.float32)
    seg = r.integers(0, 10, 64).astype(np.int32)
    np.testing.assert_array_equal(
        ref.segment_sum_ref(_t(vals), _t(seg), 12).numpy(),
        np.asarray(jref.segment_sum_ref(jnp.asarray(vals), jnp.asarray(seg),
                                        12)))
    keys, v = _stream(6)
    jc = jref.sorted_combine_ref(jnp.asarray(keys), jnp.asarray(v))
    tc = ref.sorted_combine_ref(_t(keys), _t(v))
    np.testing.assert_array_equal(tc.unique_keys.numpy(),
                                  np.asarray(jc.unique_keys))
    np.testing.assert_array_equal(tc.combined_values.numpy(),
                                  np.asarray(jc.combined_values))
