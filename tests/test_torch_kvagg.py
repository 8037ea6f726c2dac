"""repro_torch.core.kvagg against repro.core.kvagg (CPU).

Tolerances, each with its reason:

* keys, eviction streams and scan tables are exact, values included: the
  plain scan combines pair by pair in stream order, as ``jax.lax.scan``
  does, with the same per-op arithmetic;
* the fast path is exact too: on the CPU ``index_add_`` (1-D, lane by
  lane) and ``jax.ops.segment_sum`` both add in index order;
* logsumexp: rtol 1e-6, atol 1e-6 in f32 (torch's and XLA's exp/log/log1p
  may differ in the last ulp, and ``m + log(s)`` can cancel towards 0,
  where one ulp of the addends is many ulps of the result).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggops as jaggops
from repro.core import kvagg as jkvagg
from repro_torch import convert
from repro_torch.core import aggops, kvagg

EMPTY = -1
INT32_MAX = 2**31 - 1
OPS = ("count", "logsumexp", "max", "mean", "min", "sum")
#: (capacity, ways) of tests/test_kvagg_core.py and tests/test_fpe_fast.py,
#: plus ways > 32 in two buckets
GEOMETRIES = ((1, 1), (4, 2), (16, 4), (64, 4), (80, 40))
#: every op in both modes, the geometries rotated so that each mode meets
#: every geometry.  Each (op, geometry, mode) compiles the JAX function
#: once, which is what bounds the sweep; the seeds reuse that compile.
FPE_CASES = [(op, *GEOMETRIES[(i + 2 * exact) % len(GEOMETRIES)], exact)
             for i, op in enumerate(OPS) for exact in (True, False)]
SEEDS = (0, 1, 2)


def _t(x):
    return convert.tensor(x, device="cpu")


def _assert_same(want, got, op, what=""):
    w = np.asarray(jnp.asarray(want).astype(jnp.float32)
                   if jnp.asarray(want).dtype == jnp.bfloat16 else want)
    g = (got.float() if got.dtype == torch.bfloat16 else got).numpy()
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if op == "logsumexp" and np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def _assert_fpe_same(jr, tr, op):
    for name in ("table_keys", "table_values", "evict_keys", "evict_values"):
        _assert_same(getattr(jr, name), getattr(tr, name), op, name)


def _stream(seed, n=256, variety=48, raw_dtype=np.float32, pad=0.05):
    """Keys with EMPTY pads and the INT32_MAX key, raw values."""
    r = np.random.default_rng(seed)
    keys = r.integers(0, variety, n).astype(np.int32)
    keys[r.random(n) < pad] = EMPTY
    keys[r.integers(0, n, 4)] = INT32_MAX
    if raw_dtype == np.int32:
        raw = r.integers(-100, 100, n).astype(np.int32)
    else:
        raw = (r.standard_normal(n) * 4).astype(np.float32)
    return keys, raw


def _carried(op, raw, dtype=None):
    jraw = jnp.asarray(raw) if dtype is None else jnp.asarray(raw).astype(dtype)
    return np.asarray(jaggops.get(op).prepare_values(jraw))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("op,capacity,ways,exact_stream", FPE_CASES)
def test_fpe_matches_jax(op, capacity, ways, exact_stream, seed):
    keys, raw = _stream(capacity * 31 + ways + 1000 * seed)
    carried = _carried(op, raw)
    jr = jkvagg.fpe_aggregate(jnp.asarray(keys), jnp.asarray(carried),
                              capacity=capacity, ways=ways, op=op,
                              exact_stream=exact_stream)
    tr = kvagg.fpe_aggregate(_t(keys), _t(carried), capacity=capacity,
                             ways=ways, op=op, exact_stream=exact_stream)
    n, cap = keys.shape[0], kvagg._fpe_geometry(capacity, ways)[2]
    assert tr.evict_keys.shape == ((n,) if exact_stream else (n + cap,))
    _assert_fpe_same(jr, tr, op)


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("op,dtype,exact_stream", [
    # each op and each dtype in both modes
    ("sum", "bfloat16", True), ("sum", "int32", False),
    ("max", "bfloat16", False), ("max", "int32", True),
    ("min", "bfloat16", True), ("min", "int32", False)])
def test_fpe_dtypes_match_jax(op, dtype, exact_stream, seed):
    keys, raw = _stream(seed, raw_dtype=np.int32 if dtype == "int32"
                        else np.float32)
    carried = _carried(op, raw, jnp.bfloat16 if dtype == "bfloat16" else None)
    jr = jkvagg.fpe_aggregate(jnp.asarray(keys), jnp.asarray(carried),
                              capacity=16, ways=4,
                              op=op, exact_stream=exact_stream)
    tr = kvagg.fpe_aggregate(_t(keys), _t(carried), capacity=16, ways=4,
                             op=op, exact_stream=exact_stream)
    assert str(tr.table_values.dtype).endswith(dtype)
    _assert_fpe_same(jr, tr, op)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("op,exact_stream", [("mean", True),
                                             ("logsumexp", False)])
def test_fpe_resume_from_table_matches_jax(op, exact_stream, seed):
    """A table carried from the JAX package resumes in the port."""
    keys, raw = _stream(seed, n=384)
    carried = _carried(op, raw)
    kw = dict(capacity=16, ways=4, op=op, exact_stream=exact_stream)
    j0 = jkvagg.fpe_aggregate(jnp.asarray(keys[:128]),
                              jnp.asarray(carried[:128]), **kw)
    tk, tv = convert.fpe_table(j0.table_keys, j0.table_values, device="cpu")
    jr = jkvagg.fpe_aggregate(jnp.asarray(keys[128:]),
                              jnp.asarray(carried[128:]), **kw,
                              table_keys=j0.table_keys,
                              table_values=j0.table_values)
    tr = kvagg.fpe_aggregate(_t(keys[128:]), _t(carried[128:]), **kw,
                             table_keys=tk, table_values=tv)
    _assert_fpe_same(jr, tr, op)


def test_fpe_all_padding_and_empty_stream():
    keys = np.full((32,), EMPTY, np.int32)
    vals = np.zeros((32,), np.float32)
    for exact in (True, False):
        jr = jkvagg.fpe_aggregate(jnp.asarray(keys), jnp.asarray(vals),
                                  capacity=8, ways=2, exact_stream=exact)
        tr = kvagg.fpe_aggregate(_t(keys), _t(vals), capacity=8, ways=2,
                                 exact_stream=exact)
        _assert_fpe_same(jr, tr, "sum")
        assert bool((tr.table_keys == EMPTY).all())
    tr = kvagg.fpe_aggregate(_t(keys[:0]), _t(vals[:0]), capacity=8, ways=2,
                             exact_stream=False)
    assert tr.evict_keys.shape == (8,) and tr.table_keys.shape == (8,)


def test_fpe_geometry_matches_jax():
    for capacity in (1, 3, 7, 16, 100, 4096):
        for ways in (1, 2, 4, 5, 64, 128):
            assert kvagg._fpe_geometry(capacity, ways) == \
                jkvagg._fpe_geometry(capacity, ways)


def test_fast_path_falls_back_to_scan_past_the_int32_composite_bound():
    """n * max(n_buckets, cap) >= 2**31 - 1: both packages run the scan and
    pad its stream to [n + cap]."""
    r = np.random.default_rng(5)
    n, capacity = 1 << 15, 1 << 16  # n * cap == 2**31
    keys = r.integers(0, 1 << 17, n).astype(np.int32)
    vals = np.ones((n,), np.float32)
    jr = jkvagg.fpe_aggregate(jnp.asarray(keys), jnp.asarray(vals),
                              capacity=capacity, ways=1, exact_stream=False)
    tr = kvagg.fpe_aggregate(_t(keys), _t(vals), capacity=capacity, ways=1,
                             exact_stream=False)
    assert tr.evict_keys.shape == (n + capacity,)
    _assert_fpe_same(jr, tr, "sum")


def test_fast_path_guard_follows_the_limit(monkeypatch):
    """With a small limit the fast path is the scan, padded to [n + cap]."""
    keys, raw = _stream(11)
    monkeypatch.setattr(kvagg, "_COMPOSITE_LIMIT", 64)
    tr = kvagg.fpe_aggregate(_t(keys), _t(raw), capacity=16, ways=4,
                             exact_stream=False)
    jr = jkvagg.fpe_aggregate(jnp.asarray(keys), jnp.asarray(raw),
                              capacity=16, ways=4, exact_stream=True)
    np.testing.assert_array_equal(tr.evict_keys[:256].numpy(),
                                  np.asarray(jr.evict_keys))
    assert bool((tr.evict_keys[256:] == EMPTY).all())
    np.testing.assert_array_equal(tr.table_values.numpy(),
                                  np.asarray(jr.table_values))


@pytest.mark.parametrize("op", OPS)
def test_sorted_combine_matches_jax(op, monkeypatch):
    """logsumexp in f32: 4 of the combined values are not bit-identical
    (within rtol 1e-6, atol 1e-6), every one from XLA's f32 exp and log:
    with those swapped in, the port is bit-identical."""
    keys, raw = _stream(13, n=300, variety=64)
    carried = _carried(op, raw)
    jc = jkvagg.sorted_combine(jnp.asarray(keys), jnp.asarray(carried), op=op)
    tc = kvagg.sorted_combine(_t(keys), _t(carried), op=op)
    assert int(tc.n_unique) == int(jc.n_unique)
    _assert_same(jc.unique_keys, tc.unique_keys, op, "keys")
    _assert_same(jc.combined_values, tc.combined_values, op, "values")
    assert INT32_MAX in tc.unique_keys.tolist()
    if op == "logsumexp":
        want = np.asarray(jc.combined_values)
        assert (tc.combined_values.numpy() != want).sum() <= 4
        for name, fn in (("_exp", jnp.exp), ("_log", jnp.log)):
            monkeypatch.setattr(
                aggops, name,
                lambda x, fn=fn: _t(np.asarray(fn(jnp.asarray(x.numpy())))))
        tc = kvagg.sorted_combine(_t(keys), _t(carried), op=op)
        np.testing.assert_array_equal(tc.combined_values.numpy(), want)


def test_sorted_combine_edge_cases():
    for keys in ([EMPTY] * 5, [INT32_MAX] * 3, [7], []):
        k = np.asarray(keys, np.int32)
        v = np.arange(k.shape[0], dtype=np.float32)
        jc = jkvagg.sorted_combine(jnp.asarray(k), jnp.asarray(v))
        tc = kvagg.sorted_combine(_t(k), _t(v))
        assert int(tc.n_unique) == int(jc.n_unique)
        _assert_same(jc.unique_keys, tc.unique_keys, "sum")
        _assert_same(jc.combined_values, tc.combined_values, "sum")


@pytest.mark.parametrize("seed", [17, 18, 19])
@pytest.mark.parametrize("op,bpe,exact_stream", [("mean", True, True),
                                                 ("max", False, False)])
def test_two_level_aggregate_matches_jax(op, bpe, exact_stream, seed):
    keys, raw = _stream(seed, n=320, variety=80)
    carried = _carried(op, raw)
    kw = dict(capacity=16, ways=4, op=op, bpe=bpe, exact_stream=exact_stream)
    jr = jkvagg.two_level_aggregate(jnp.asarray(keys), jnp.asarray(carried),
                                    **kw)
    tr = kvagg.two_level_aggregate(_t(keys), _t(carried), **kw)
    for name in jr._fields:
        _assert_same(getattr(jr, name), getattr(tr, name), op, name)
    assert float(kvagg.reduction_ratio(tr)) == pytest.approx(
        float(jkvagg.reduction_ratio(jr)), rel=1e-6)


def test_n_distinct_keys_matches_jax():
    for keys in ([3, 3, EMPTY, INT32_MAX, INT32_MAX, -5, 0], [EMPTY] * 4, []):
        k = np.asarray(keys, np.int32)
        assert int(kvagg.n_distinct_keys(_t(k))) == \
            int(jkvagg.n_distinct_keys(jnp.asarray(k)))


def test_length_group_matches_jax():
    lengths = np.arange(0, 80, dtype=np.int32)
    np.testing.assert_array_equal(
        kvagg.length_group(_t(lengths)).numpy(),
        np.asarray(jkvagg.length_group(jnp.asarray(lengths))))
    np.testing.assert_array_equal(
        kvagg.length_group(_t(lengths), base=16, n_groups=3).numpy(),
        np.asarray(jkvagg.length_group(jnp.asarray(lengths), 16, 3)))
