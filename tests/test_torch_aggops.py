"""repro_torch.core.aggops against repro.core.aggops (CPU).

Tolerances: hashes, identities, integer and max/min results and sums
added in the same order are exact, and so is logsumexp in bf16: the
port's ``logaddexp`` repeats ``jnp.logaddexp`` op by op, each op rounding
to bf16.  In f32 logsumexp is held to rtol 1e-6, atol 1e-6, and the
count of elements that are not bit-identical is stated: the port's f32
exp, log1p and log are correctly rounded, XLA's are approximations that
miss by an ulp or two, and ``m + log(s)`` may cancel towards 0.  With
XLA's transcendentals swapped in, the port is bit-identical in f32 too
(``test_logsumexp_differs_only_by_the_f32_transcendentals``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggops as jaggops
from repro_torch import convert
from repro_torch.core import aggops

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}


def _t(x):
    return convert.tensor(x, device="cpu")


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _n_differ(got, want) -> int:
    """Elements that are not bit-identical (NaN equals NaN)."""
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    return int((~same).sum())


def _assert_close(jax_out, torch_out, op, dtype, max_differ=0):
    """Exact, except f32 logsumexp: rtol 1e-6, atol 1e-6, and at most
    ``max_differ`` elements not bit-identical."""
    want = np.asarray(jax_out).astype(np.float64)
    got = _np(torch_out).astype(np.float64)
    if op == "logsumexp" and dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert _n_differ(got, want) <= max_differ
    else:
        np.testing.assert_array_equal(got, want)


def _xla(fn, jdtype):
    """A jnp transcendental as a torch op on CPU tensors."""
    def op(x):
        out = fn(jnp.asarray(x.float().numpy()).astype(jdtype))
        return _t(np.asarray(out))
    return op


def _values(rng, n, dtype):
    if dtype == "int32":
        return rng.integers(-1000, 1000, n).astype(np.int32)
    v = jnp.asarray(rng.standard_normal(n).astype(np.float32) * 4)
    return np.asarray(v.astype(DTYPES[dtype][0]))


@pytest.mark.parametrize("n_buckets", [1, 3, 16, 1000, 2**20])
def test_hash_key_bit_exact(n_buckets, rng):
    edge = np.array([-1, 0, 1, INT32_MIN, INT32_MAX, INT32_MIN + 1, -2],
                    np.int32)
    rand = rng.integers(INT32_MIN, INT32_MAX, 4096, dtype=np.int64)
    keys = np.concatenate([edge, rand.astype(np.int32)])
    want = np.asarray(jaggops.hash_key(jnp.asarray(keys), n_buckets))
    got = aggops.hash_key(_t(keys), n_buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    scalar = [aggops.hash_key_int(int(k), n_buckets) for k in keys[:64]]
    np.testing.assert_array_equal(scalar, want[:64])


def test_registry_names_match():
    assert aggops.names() == jaggops.names()
    assert aggops.get("mean").lanes == 2
    with pytest.raises(ValueError, match="logsumexp"):
        aggops.get("median")


@pytest.mark.parametrize("op,dtype", [
    (op, dtype) for op in ("sum", "max", "min", "count", "mean", "logsumexp")
    for dtype in ("float32", "bfloat16", "int32", "int16")
    # logsumexp lifts integers to f32 in prepare: no integer identity
    if not (op == "logsumexp" and dtype in ("int32", "int16"))])
def test_identity_matches(op, dtype):
    jd, td = ({"int16": (jnp.int16, torch.int16)} | DTYPES)[dtype]
    want = jaggops.get(op).identity(jd)
    got = aggops.get(op).identity(td)
    assert got.dtype == td and got.dim() == 0
    assert float(got) == float(want)
    if op in ("max", "min") and dtype in ("int32", "int16"):
        assert np.isfinite(float(got))  # iinfo bounds, never ±inf


@pytest.mark.parametrize("op,dtype", [
    (op, dtype) for op in ("sum", "max", "min", "count", "logsumexp")
    for dtype in ("float32", "bfloat16", "int32")
    # logsumexp combines carried floats only
    if not (op == "logsumexp" and dtype == "int32")])
def test_combine_matches(op, dtype, rng):
    a, b = _values(rng, 256, dtype), _values(rng, 256, dtype)
    want = jaggops.get(op).combine(jnp.asarray(a), jnp.asarray(b))
    got = aggops.get(op).combine(_t(a), _t(b))
    assert got.dtype == DTYPES[dtype][1]
    # f32 logsumexp: at most 20 of these 256 values are not bit-identical
    # (11 in this file's order; 3.1% of 65,536 random pairs), every one
    # from XLA's f32 exp/log1p (see the next test)
    _assert_close(want, got, op, dtype, max_differ=20)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logsumexp_differs_only_by_the_f32_transcendentals(dtype,
                                                           monkeypatch):
    """With XLA's exp, log1p and log in place of the port's correctly
    rounded ones, combine and segment_reduce are bit-identical."""
    rng = np.random.default_rng(12)
    jd = DTYPES[dtype][0]
    for name, fn in (("_exp", jnp.exp), ("_log1p", jnp.log1p),
                     ("_log", jnp.log)):
        monkeypatch.setattr(aggops, name, _xla(fn, jd))
    a, b = _values(rng, 256, dtype), _values(rng, 256, dtype)
    edge = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.0], np.float32)
    a = np.concatenate([a, np.repeat(edge, 6).astype(a.dtype)])
    b = np.concatenate([b, np.tile(edge, 6).astype(b.dtype)])
    jop, top = jaggops.get("logsumexp"), aggops.get("logsumexp")
    want = np.asarray(jop.combine(jnp.asarray(a), jnp.asarray(b))
                      .astype(jnp.float32))
    got = _np(top.combine(_t(a), _t(b)))
    assert _n_differ(got, want) == 0
    seg = rng.integers(0, 40, 256).astype(np.int32)
    want = jop.segment_reduce(jnp.asarray(a[:256]), jnp.asarray(seg),
                              num_segments=45)
    got = top.segment_reduce(_t(a[:256]), _t(seg), 45)
    assert _n_differ(_np(got), np.asarray(want.astype(jnp.float32))) == 0


def test_identity_neutral_under_combine():
    for name in ("sum", "max", "min", "logsumexp"):
        op = aggops.get(name)
        x = torch.tensor([-3.5, 0.0, 7.25])
        assert torch.equal(op.combine(x, op.identity(torch.float32)), x)
    for name in ("sum", "max", "min"):
        op = aggops.get(name)
        xi = torch.tensor([-3, 0, 7], dtype=torch.int32)
        assert torch.equal(op.combine(xi, op.identity(torch.int32)), xi)


@pytest.mark.parametrize("op", ["sum", "max", "min", "count", "mean",
                                "logsumexp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_prepare_finalize_match(op, dtype, rng):
    raw = _values(rng, 64, dtype)
    jop, top = jaggops.get(op), aggops.get(op)
    jc = jop.prepare_values(jnp.asarray(raw))
    tc = top.prepare_values(_t(raw))
    assert str(tc.dtype).split(".")[-1] == str(jc.dtype)
    assert tuple(tc.shape) == tuple(jc.shape)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc).astype(np.float64))
    _assert_close(jop.finalize_values(jc), top.finalize_values(tc),
                  "mean" if op == "mean" else op, dtype)


def test_mean_finalize_zero_count_is_zero():
    out = aggops.get("mean").finalize_values(torch.zeros((4, 2)))
    assert torch.equal(out, torch.zeros(4))


def test_prepare_lane_mismatch_raises():
    bad = aggops.AggOp(name="bad", combine=lambda a, b: a + b,
                       identity=lambda d, device=None: torch.tensor(0),
                       segment_reduce=None, lanes=2)
    with pytest.raises(ValueError, match="lanes=2"):
        bad.prepare_values(torch.zeros(3))


@pytest.mark.parametrize("op", ["sum", "max", "min", "count", "mean",
                                "logsumexp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_segment_reduce_matches(op, dtype, rng):
    """Every segment, empty ones included (their start values are the
    JAX package's: 0, ±inf / iinfo bounds, -inf for logsumexp)."""
    n, segs = 200, 40
    raw = _values(rng, n, dtype)
    seg = rng.integers(0, segs - 5, n).astype(np.int32)  # 5 empty segments
    jop, top = jaggops.get(op), aggops.get(op)
    jc = jop.prepare_values(jnp.asarray(raw))
    tc = top.prepare_values(_t(raw))
    want = jop.segment_reduce(jc, jnp.asarray(seg), num_segments=segs)
    got = top.segment_reduce(tc, _t(seg), segs)
    assert tuple(got.shape) == tuple(want.shape)
    # f32 logsumexp: at most 3 of 40 segments are not bit-identical (1 in
    # this file's order, 0-1 in other draws), from XLA's f32 exp and log
    _assert_close(want, got, op, dtype, max_differ=3)
