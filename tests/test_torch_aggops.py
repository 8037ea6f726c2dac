"""repro_torch.core.aggops against repro.core.aggops (CPU).

Tolerances: hashes, identities, integer and max/min results and sums
added in the same order are exact.  logsumexp is held to rtol 1e-6,
atol 1e-6 in f32 (torch's and XLA's exp/log/log1p differ in the last ulp,
and ``m + log(s)`` may cancel towards 0).  In bf16 ``jnp.logaddexp``
rounds every intermediate while ``torch.logaddexp`` computes in f32 and
rounds once, so the two may part by two bf16 ulps of the larger input:
|got - want| <= 2**-6 * max(|a|, |b|, 1).
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


def _assert_close(jax_out, torch_out, op, dtype, scale=None):
    """``scale``: the larger input magnitude per element (bf16 logsumexp)."""
    want = np.asarray(jax_out).astype(np.float64)
    got = _np(torch_out).astype(np.float64)
    if op == "logsumexp" and dtype == "bfloat16":
        scale = np.maximum(np.abs(want) if scale is None else scale, 1.0)
        same = got == want  # equal infinities included
        with np.errstate(invalid="ignore"):  # inf - inf where both agree
            near = np.abs(got - want) <= 2**-6 * scale
        assert np.all(same | near)
    elif op == "logsumexp":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


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
    scale = np.maximum(np.abs(a.astype(np.float64)),
                       np.abs(b.astype(np.float64)))
    _assert_close(want, got, op, dtype, scale)


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
    _assert_close(want, got, op, dtype)
